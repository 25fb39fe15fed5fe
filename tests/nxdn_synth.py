"""NXDN frame synthesizer for tests."""
import numpy as np

from digiham_jax.fec import interleave
from digiham_jax.fec.crc import crc6_nxdn, crc12_nxdn
from digiham_jax.fec.viterbi import conv_encode
from digiham_jax.protocols.nxdn.components import Scrambler
from digiham_jax.protocols.nxdn.phases import FRAME_SIZE, FRAME_SYNC, SYNC_SIZE


def _conv_and_puncture(bits, keep_mask_len, skip_fn):
    coded = conv_encode(np.asarray(bits, np.int64)).astype(np.uint8)
    coded_bits = np.empty(len(coded) * 2, np.uint8)
    coded_bits[0::2] = (coded >> 1) & 1
    coded_bits[1::2] = coded & 1
    return np.array([coded_bits[i] for i in range(keep_mask_len)
                     if not skip_fn(i)], np.uint8)


def encode_sacch_unit(structure_index: int, payload18: np.ndarray,
                      scramble: bool = True) -> np.ndarray:
    """-> 30 dibits (scrambled at in-frame offset 8)."""
    info = np.zeros(26, np.uint8)
    s = structure_index ^ 0b11
    info[0] = (s >> 1) & 1
    info[1] = s & 1
    info[8:26] = payload18
    crc = int(crc6_nxdn(26).compute_np(info))
    bits36 = np.concatenate([
        info, np.array([(crc >> (5 - i)) & 1 for i in range(6)], np.uint8),
        np.zeros(4, np.uint8)])
    punctured = _conv_and_puncture(bits36, 72, lambda i: (i + 1) % 6 == 0)
    # inverse of the 12x5 de-interleave: interleaved[table[j]] = punctured[j]
    bits60 = np.zeros(60, np.uint8)
    bits60[interleave.nxdn_sacch()] = punctured
    dibits = ((bits60[0::2] << 1) | bits60[1::2]).astype(np.uint8)
    if scramble:
        dibits = Scrambler.descramble(dibits, 8)  # self-inverse
    return dibits


def encode_facch1(message_type: int, scramble_offset: int | None):
    """-> 72 dibits."""
    info = np.zeros(80, np.uint8)
    for i in range(6):
        info[2 + i] = (message_type >> (5 - i)) & 1
    crc = int(crc12_nxdn(80).compute_np(info))
    bits96 = np.concatenate([
        info, np.array([(crc >> (11 - i)) & 1 for i in range(12)], np.uint8),
        np.zeros(4, np.uint8)])
    punctured = _conv_and_puncture(bits96, 192, lambda i: (i - 1) % 4 == 0)
    bits144 = np.zeros(144, np.uint8)
    bits144[interleave.nxdn_facch1()] = punctured
    dibits = ((bits144[0::2] << 1) | bits144[1::2]).astype(np.uint8)
    if scramble_offset is not None:
        dibits = Scrambler.descramble(dibits, scramble_offset)
    return dibits


def encode_lich(rf_type, functional, option, direction=0) -> np.ndarray:
    byte = (rf_type << 5) | (functional << 3) | (option << 1) | direction
    bits = [(byte >> (6 - i)) & 1 for i in range(7)]
    check = bits[0] ^ bits[1] ^ bits[2] ^ bits[3]
    dibits = np.array([b << 1 for b in bits + [check]], np.uint8)
    return Scrambler.descramble(dibits, 0)


def vcall_superframe_bytes(call_type, source, dest) -> np.ndarray:
    """9 superframe bytes -> [4, 18] per-unit payload bits."""
    data = bytearray(9)
    data[0] = 0x01  # VCALL
    data[2] = (call_type & 7) << 5
    data[3] = (source >> 8) & 0xFF
    data[4] = source & 0xFF
    data[5] = (dest >> 8) & 0xFF
    data[6] = dest & 0xFF
    bits = np.unpackbits(np.frombuffer(bytes(data), np.uint8))
    return bits[:72].reshape(4, 18)


def voice_slot_dibits(payload72, offset) -> np.ndarray:
    """Scramble a raw 72-dibit voice payload for slot at in-frame offset."""
    return Scrambler.descramble(np.asarray(payload72, np.uint8), offset)


def nxdn_frame(lich_args, sacch_dibits=None, slots=None) -> np.ndarray:
    """Assemble a 192-dibit frame. slots: list of 2 dibit arrays (already
    scrambled) or None -> zero fill."""
    frame = np.zeros(FRAME_SIZE, np.uint8)
    frame[:SYNC_SIZE] = FRAME_SYNC
    frame[SYNC_SIZE:SYNC_SIZE + 8] = encode_lich(*lich_args)
    pos = SYNC_SIZE + 8
    if sacch_dibits is not None:
        frame[pos:pos + 30] = sacch_dibits
    pos += 30
    for i in range(2):
        if slots is not None and slots[i] is not None:
            frame[pos:pos + 72] = slots[i]
        pos += 72
    return frame
