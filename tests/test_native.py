"""Native C++ runtime tests (and their numpy fallbacks)."""
import threading

import numpy as np
import pytest

from digiham_jax import native


def test_native_built():
    assert native.HAVE_NATIVE, "C++ runtime failed to build"


class TestPacking:
    def test_hamming_distance(self):
        a = np.array([3, 1, 3, 3], np.uint8)
        b = np.array([3, 3, 3, 1], np.uint8)
        assert native.hamming_distance(a, b) == 2
        assert native.hamming_distance(a, a) == 0

    def test_pack_dibits(self):
        d = np.array([1, 3, 0, 2, 2, 0, 3, 1], np.uint8)
        want = bytes([(1 << 6) | (3 << 4) | (0 << 2) | 2,
                      (2 << 6) | (0 << 4) | (3 << 2) | 1])
        assert native.pack_dibits(d) == want

    def test_pack_bits(self):
        bits = np.array([1, 0, 1, 0, 1, 0, 1, 0], np.uint8)
        assert native.pack_bits_msb(bits) == b"\xAA"
        assert native.pack_bits_lsb(bits) == b"\x55"

    def test_unpack_matches_pack(self):
        rng = np.random.default_rng(0)
        d = rng.integers(0, 4, 400).astype(np.uint8)
        packed = np.frombuffer(native.pack_dibits(d), np.uint8)
        # cross-check against the protocol-layer packer
        from digiham_jax.protocols.dmr.phases import pack_dibits as py_pack
        assert packed.tobytes() == py_pack(d)


class TestSyncScan:
    def test_finds_pattern(self):
        rng = np.random.default_rng(1)
        data = rng.integers(0, 4, 1000).astype(np.uint8)
        pattern = np.array([3, 1, 3, 3, 3, 3, 1, 1, 1, 3], np.uint8)
        data[531:541] = pattern
        off = native.sync_scan(data, pattern, 0)
        assert 0 <= off <= 531
        d = native.sync_distances(data, pattern)
        assert d[531] == 0

    def test_tolerance(self):
        data = np.zeros(100, np.uint8)
        pattern = np.full(10, 3, np.uint8)
        corrupted = pattern.copy()
        corrupted[[2, 7]] = 0  # 4 bit errors
        data[50:60] = corrupted
        assert native.sync_scan(data, pattern, 3) == -1
        assert native.sync_scan(data, pattern, 4) == 50

    def test_no_match(self):
        assert native.sync_scan(np.zeros(5, np.uint8),
                                np.ones(10, np.uint8), 0) == -1


class TestRingBuffer:
    def test_write_peek_consume(self):
        rb = native.RingBuffer(1 << 10)
        assert rb.write(b"hello world") == 11
        assert rb.available() == 11
        assert rb.peek(5) == b"hello"
        assert rb.consume(6) == 6
        assert rb.peek(5) == b"world"

    def test_wraparound(self):
        rb = native.RingBuffer(16)
        for i in range(100):
            data = bytes([i % 256]) * 7
            assert rb.write(data) == 7
            assert rb.peek(7) == data
            assert rb.consume(7) == 7

    def test_full_buffer_partial_write(self):
        rb = native.RingBuffer(16)
        assert rb.write(b"x" * 16) == 16
        assert rb.write(b"y") == 0
        rb.consume(4)
        assert rb.write(b"y" * 8) == 4

    def test_threaded_producer_consumer(self):
        rb = native.RingBuffer(1 << 12)
        total = 200_000
        src = np.random.default_rng(2).integers(
            0, 256, total).astype(np.uint8).tobytes()
        received = bytearray()

        def producer():
            sent = 0
            while sent < total:
                n = rb.write(src[sent:sent + 1024])
                sent += n

        t = threading.Thread(target=producer)
        t.start()
        while len(received) < total:
            chunk = rb.peek(4096)
            if chunk:
                rb.consume(len(chunk))
                received.extend(chunk)
        t.join()
        assert bytes(received) == src


class TestDeinterleave:
    def test_matches_numpy(self):
        rng = np.random.default_rng(3)
        frames, channels = 1000, 8
        x = rng.normal(0, 1, frames * channels).astype(np.float32)
        got = native.deinterleave_f32(x, channels)
        want = x.reshape(frames, channels).T
        np.testing.assert_array_equal(got, want)
