"""Systematic GF(2) linear block codes as batched, device-friendly integer ops.

The reference (jketterl/digiham) decodes each short block code with a
parity-check-matrix syndrome computation followed by a linear scan over a
hand-pasted ``{syndrome, error_pattern}`` table (e.g.
``src/dmr_decoder/golay_20_8.c:1421-1435``). Here each code is described by
its parity-check rows only; the syndrome->error table is *derived* at import
time by enumerating error patterns in exactly the order the reference's
offline syndrome generators used (``golay_20_8_syndrome_generator.c:20-31``:
single bits ascending, then pairs ``(i,k<i)``, then triples ``(i,k<i,l<k)``),
with first-match-wins semantics — so decode behavior matches the reference
even for syndromes beyond the code's guaranteed correction radius.

Codewords are represented as packed integers with the reference's bit
convention: bit 0 (LSB) is the *last* received bit; the parity-check rows
carry an identity block in the low-order bits (``H = [-P^T | I]``). Decoding
is a popcount-parity per row (elementwise ops) plus one gather from a dense
``2**(n-k)`` table — no scans, fully batched over arbitrary leading dims.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockCode:
    """A systematic GF(2) block code defined by parity-check rows.

    parity_rows: one int per check row; bit ``l`` of the row is the H-matrix
      coefficient of codeword bit ``l`` (LSB = last received bit). Row 0
      contributes the *most* significant syndrome bit, matching the
      reference's ``parity = (parity << 1) | bit`` assembly
      (``src/dmr_decoder/hamming_7_4.c:39-55``).
    correct_bits: error-pattern enumeration depth (1, 2 or 3).
    """

    name: str
    n: int
    k: int
    parity_rows: tuple[int, ...]
    correct_bits: int

    @property
    def r(self) -> int:
        return self.n - self.k

    @functools.cached_property
    def syndrome_table(self) -> np.ndarray:
        """Dense syndrome -> error-pattern table; -1 marks uncorrectable."""
        rows = np.asarray(self.parity_rows, dtype=np.uint64)
        table = np.full(1 << self.r, -1, dtype=np.int64)
        table[0] = 0

        def syndrome(pattern: int) -> int:
            s = 0
            for row in rows:
                bit = bin(int(row) & pattern).count("1") & 1
                s = (s << 1) | bit
            return s

        def add(pattern: int) -> None:
            s = syndrome(pattern)
            if s != 0 and table[s] < 0:
                table[s] = pattern

        # Enumeration order mirrors the reference syndrome generators.
        for i in range(self.n):
            add(1 << i)
            if self.correct_bits >= 2:
                for kk in range(i):
                    add((1 << i) | (1 << kk))
                    if self.correct_bits >= 3:
                        for ll in range(kk):
                            add((1 << i) | (1 << kk) | (1 << ll))
        return table

    @functools.cached_property
    def generator_rows(self) -> np.ndarray:
        """Systematic generator rows (for encoding): data bit j (j=0 is the
        first transmitted bit, i.e. codeword bit n-1) -> full codeword mask."""
        rows = []
        for j in range(self.k):
            data_bit = 1 << (self.n - 1 - j)
            word = data_bit
            for ri, row in enumerate(self.parity_rows):
                parity_pos = self.r - 1 - ri  # identity block position
                bit = bin(int(row) & data_bit).count("1") & 1
                if bit:
                    word |= 1 << parity_pos
            rows.append(word)
        return np.asarray(rows, dtype=np.int64)

    def encode(self, data: np.ndarray | int) -> np.ndarray:
        """Encode k-bit data ints (numpy, host-side; used by tests and TX)."""
        data = np.asarray(data, dtype=np.int64)
        out = np.zeros_like(data)
        for j in range(self.k):
            bit = (data >> (self.k - 1 - j)) & 1
            out ^= bit * self.generator_rows[j]
        return out


def _parity_bits(words: jnp.ndarray, rows: jnp.ndarray) -> jnp.ndarray:
    """Per-row popcount parity: [...,]-int32 words x [r] rows -> [..., r]."""
    masked = words[..., None].astype(jnp.uint32) & rows.astype(jnp.uint32)
    return (jax.lax.population_count(masked) & 1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=0)
def decode(code: BlockCode, words: jnp.ndarray):
    """Batched syndrome decode.

    words: integer array of packed codewords (any leading shape).
    Returns (corrected_words int32, ok bool) — ``ok`` False where the
    syndrome is not in the correction table (reference returns false and the
    caller drops the frame).
    """
    words = words.astype(jnp.int32)
    rows = jnp.asarray(np.asarray(code.parity_rows, dtype=np.int64).astype(np.uint32).view(np.int32))
    par = _parity_bits(words, rows)
    weights = jnp.asarray(
        [1 << (code.r - 1 - i) for i in range(code.r)], dtype=jnp.int32
    )
    syndrome = jnp.sum(par * weights, axis=-1)
    table = jnp.asarray(code.syndrome_table.astype(np.int32))
    err = table[syndrome]
    ok = err >= 0
    corrected = words ^ jnp.where(ok, err, 0)
    return corrected, ok


_POP8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.int64)


def decode_np(code: BlockCode, words) -> tuple[np.ndarray, np.ndarray]:
    """Host-side variant of :func:`decode` for the control plane.

    Scalar fast path uses python int popcounts (the per-frame hot call in
    the protocol phase machines); arrays use byte-LUT parity."""
    if np.isscalar(words) or getattr(words, "ndim", None) == 0:
        w = int(words)
        s = 0
        for row in code.parity_rows:
            s = (s << 1) | ((w & int(row)).bit_count() & 1)
        err = int(code.syndrome_table[s])
        if err < 0:
            return np.int64(w), np.bool_(False)
        return np.int64(w ^ err), np.bool_(True)

    words = np.asarray(words, dtype=np.int64)
    syndrome = np.zeros_like(words)
    nbytes = (code.n + 7) // 8
    for row in code.parity_rows:
        masked = words & row
        pop = np.zeros_like(words)
        for b in range(nbytes):
            pop += _POP8[(masked >> (8 * b)) & 0xFF]
        syndrome = (syndrome << 1) | (pop & 1)
    err = code.syndrome_table[syndrome]
    ok = err >= 0
    corrected = words ^ np.where(ok, err, 0)
    return corrected, ok
