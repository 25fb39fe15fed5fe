"""DMR full-LC RS(12,9): the opt-in decode-quality improvement over the
reference (which ignores the parity bytes — reference lc.cpp:8-11 TODO).
Default-off keeps golden/metadata parity; DIGIHAM_DMR_RS129=1 validates
and single-error-corrects voice-header LCs."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from digiham_jax.fec import rs129


def test_generator_derivation():
    # (x+a)(x+a^2)(x+a^3) over GF(256)/0x11D — asserted at import too
    assert rs129._gen_poly() == [0x40, 0x38, 0x0E, 0x01]


def test_roundtrip_and_masks():
    rng = np.random.default_rng(5)
    for _ in range(200):
        data = bytes(rng.integers(0, 256, 9, dtype=np.uint8))
        par = rs129.encode(data)
        assert rs129.check(data + par) == (True, data)
        masked = bytes(b ^ rs129.MASK_VOICE_LC_HEADER for b in par)
        assert rs129.check(data + masked,
                           mask=rs129.MASK_VOICE_LC_HEADER) == (True, data)
        # wrong mask must not validate
        ok, _ = rs129.check(data + masked,
                            mask=rs129.MASK_TERMINATOR_WITH_LC)
        assert not ok


def test_single_error_corrected_double_detected():
    rng = np.random.default_rng(7)
    for _ in range(300):
        data = bytes(rng.integers(0, 256, 9, dtype=np.uint8))
        w = bytearray(data + rs129.encode(data))
        p = int(rng.integers(0, 12))
        w[p] ^= int(rng.integers(1, 256))
        ok, d = rs129.check(bytes(w))
        assert ok and d == data
        # second error: distance-4 code detects (never miscorrects into
        # a wrong accept of different data)
        p2 = (p + 1 + int(rng.integers(0, 10))) % 12
        w[p2] ^= int(rng.integers(1, 256))
        ok2, d2 = rs129.check(bytes(w))
        assert not ok2 or d2 == data


def _decode_frames(frames, env):
    """Drive data+voice frames through the decoder with env patches."""
    from digiham_jax.protocols.dmr import make_decoder
    from digiham_jax.runtime.meta import PipelineMetaWriter

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        events = []
        dec = make_decoder()
        dec.set_meta_writer(PipelineMetaWriter(
            lambda b: events.append(b.decode())))
        dec.process(np.concatenate(frames))
        return "".join(events)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _stream(corrupt_lc_bits=0):
    from dmr_synth import data_frame, group_lc, voice_frame
    lc9 = group_lc(91, 3141592)
    hdr = data_frame(0, 1, lc9)  # DATA_TYPE_VOICE_LC = 1
    if corrupt_lc_bits:
        # corrupt LC BYTES pre-BPTC (BPTC stays valid) with STALE parity
        # (computed for the original lc9): the RS layer is the only
        # check that can catch this — exactly the reference's blind spot
        from digiham_jax.fec import bptc, rs129 as rs
        from digiham_jax.protocols.dmr.phases import (CACH_SIZE,
                                                      SYNC_SIZE)
        bad = bytearray(lc9)
        bad[3] ^= 0x41  # corrupt the target id
        if corrupt_lc_bits > 1:
            bad[7] ^= 0x07  # and the source id (2 byte errors: detect)
        parity = bytes(b ^ rs.MASK_VOICE_LC_HEADER
                       for b in rs.encode(lc9))  # stale parity
        frame = data_frame(0, 1, bytes(bad))
        data_bits = np.unpackbits(
            np.frombuffer(bytes(bad) + parity, np.uint8))
        bits196 = bptc.encode(data_bits.astype(np.int64))
        dib = ((bits196[0::2] << 1) | bits196[1::2]).astype(np.uint8)
        lo2 = CACH_SIZE + 54 + SYNC_SIZE + 5
        frame[CACH_SIZE:CACH_SIZE + 49] = dib[:49]
        frame[lo2:lo2 + 49] = dib[49:]
        hdr = frame
    payload = np.tile([1, 3, 0, 2], 27)
    voices = [voice_frame(s % 2, payload, sync=True) for s in range(4)]
    return [np.zeros(40, np.uint8), hdr] + voices


def test_flag_off_reference_faithful():
    """Default: corrupted LC bytes flow through to metadata (exactly the
    reference's behavior — parity ignored)."""
    meta = _decode_frames(_stream(corrupt_lc_bits=1),
                          {"DIGIHAM_DMR_RS129": "0"})
    # bad[3] ^= 0x41 is the target's high byte: 0x41<<16 | 91 = 4259931
    assert "target:4259931" in meta  # the corrupted id leaks through


def test_flag_on_corrects_single_byte_error():
    """RS mode: the single corrupted LC byte is CORRECTED — metadata
    carries the true ids where the reference would publish garbage."""
    meta = _decode_frames(_stream(corrupt_lc_bits=1),
                          {"DIGIHAM_DMR_RS129": "1"})
    assert "source:3141592" in meta and "target:91" in meta


def test_flag_on_drops_uncorrectable():
    """Two corrupted LC bytes: detected and DROPPED (no garbled ids)."""
    meta = _decode_frames(_stream(corrupt_lc_bits=2),
                          {"DIGIHAM_DMR_RS129": "1"})
    assert "3141592" not in meta or "target:91" not in meta


def test_flag_on_clean_stream_matches_flag_off():
    """On a clean spec-true stream (synth emits real parity) both modes
    publish identical metadata."""
    a = _decode_frames(_stream(), {"DIGIHAM_DMR_RS129": "0"})
    b = _decode_frames(_stream(), {"DIGIHAM_DMR_RS129": "1"})
    assert a == b and "source:3141592" in a
