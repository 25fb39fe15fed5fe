"""Vectorized Viterbi decoders for the rate-1/2 convolutional codes.

Three protocol variants share one engine (reference behavior):
- YSF 16-state K=5 (src/ysf_decoder/trellis.c:8-109)
- NXDN 16-state K=5 with blocked start states exploiting 4 known leading
  zeros (src/nxdn_decoder/trellis.cpp:29-101)
- D-Star 4-state K=3 (src/dstar_decoder/header.cpp:76-146)

State = the last ``B`` decoded bits, newest in the MSB. A transition from
previous state ``p`` with decoded bit ``b`` emits ``TRANSITIONS[p][b]`` and
lands in state ``(b << (B-1)) | (p >> 1)``. Tie-breaking matches the
reference exactly: the predecessor with LSB 0 wins equal metrics, and the
lowest-numbered final state wins the final selection.

The engine is a ``lax.scan`` over time with an [S]-wide min-plus step —
path metrics live in vector registers; decisions are stored as one int per
step for an O(T) traceback scan. ``vmap`` over frames/channels batches it.

Divergence note: the reference YSF decoder accumulates its path metric in a
uint8 which can wrap for extremely corrupted input (>255 bit errors within
one frame); we use int32. Such frames fail the downstream CRC in both
implementations.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Shared 16-state transition table: expected dibit emitted when leaving
# ``previous state`` (row) with decoded bit 0 / 1 (column). Identical in the
# YSF spec Appendix B and NXDN (trellis.c:8-25, trellis.cpp:10-27).
TRANSITIONS_16 = np.array(
    [
        [0b00, 0b11], [0b11, 0b00], [0b10, 0b01], [0b01, 0b10],
        [0b01, 0b10], [0b10, 0b01], [0b11, 0b00], [0b00, 0b11],
        [0b01, 0b10], [0b10, 0b01], [0b11, 0b00], [0b00, 0b11],
        [0b00, 0b11], [0b11, 0b00], [0b10, 0b01], [0b01, 0b10],
    ],
    dtype=np.int32,
)

# D-Star 4-state table (header.cpp:76-81) — equals the first 4 rows.
TRANSITIONS_4 = TRANSITIONS_16[:4].copy()


def _check_blocked_steps(num_states: int, blocked_steps: int) -> None:
    """The NXDN rotating start-state mask self-extinguishes after
    ``bits_per_state`` steps, and the native C++ kernel
    (digiham_native.cpp:126,146) always runs the full rotation when
    ``blocked_steps`` is truthy. Restricting the accepted values to 0 or
    ``bits_per_state`` keeps every dispatch path (jax / numpy / native)
    semantically identical; no reference call site uses anything else
    (nxdn trellis.cpp:34 always blocks the 4 known leading zeros)."""
    bits_per_state = num_states.bit_length() - 1
    if blocked_steps not in (0, bits_per_state):
        raise ValueError(
            f"blocked_steps must be 0 or {bits_per_state} for "
            f"{num_states}-state decode, got {blocked_steps}")


def _branch_tables(num_states: int, transitions: np.ndarray):
    """Precompute per-(new_state, k) predecessor and expected dibit."""
    bits = num_states.bit_length() - 1
    prev = np.zeros((num_states, 2), dtype=np.int32)
    expected = np.zeros((num_states, 2), dtype=np.int32)
    for i in range(num_states):
        outbit = (i >> (bits - 1)) & 1
        for k in range(2):
            p = ((i << 1) & (num_states - 2)) | k
            prev[i, k] = p
            expected[i, k] = transitions[p][outbit]
    return prev, expected


@functools.partial(jax.jit,
                   static_argnames=("num_states", "blocked_steps"))
def viterbi_decode(observed, num_states: int = 16, blocked_steps: int = 0):
    """Decode one rate-1/2 stream.

    observed: [..., T] int array of received dibits (0-3).
    num_states: 16 (YSF/NXDN) or 4 (D-Star).
    blocked_steps: NXDN prior-knowledge window — for the first N steps, a
      new state whose low ``blocked`` bits overlap the rotating block mask
      only considers the k=0 predecessor (trellis.cpp:34,56-57,84-85).

    Returns (bits [..., T] int32, metric [...] int32).
    """
    _check_blocked_steps(num_states, blocked_steps)
    transitions = TRANSITIONS_16 if num_states == 16 else TRANSITIONS_4
    prev_tbl, exp_tbl = _branch_tables(num_states, transitions)
    prev_tbl = jnp.asarray(prev_tbl)
    exp_tbl = jnp.asarray(exp_tbl)
    bits_per_state = num_states.bit_length() - 1

    obs = observed.astype(jnp.int32)
    batch_shape = obs.shape[:-1]
    T = obs.shape[-1]
    obs_flat = obs.reshape((-1, T))

    # Per-step k=1 permission mask for blocked start states.
    if blocked_steps:
        allow = np.ones((T, num_states), dtype=bool)
        blocked = num_states - 1
        for t in range(min(blocked_steps, T)):
            for i in range(num_states):
                if i & blocked:
                    allow[t, i] = False
            blocked = (blocked << 1) & (num_states - 1)
        allow_k1 = jnp.asarray(allow)
    else:
        allow_k1 = jnp.ones((T, num_states), dtype=bool)

    BIG = jnp.int32(1 << 28)

    def forward(metrics, inputs):
        ob, allow = inputs
        # distance of observed dibit to each (state, k) expected dibit
        dist = jax.lax.population_count(ob ^ exp_tbl)  # [S, 2]
        cand = metrics[prev_tbl] + dist  # [S, 2]
        cand_k1 = jnp.where(allow, cand[:, 1], BIG)
        take_k1 = cand_k1 < cand[:, 0]  # strict: k=0 wins ties
        new_metrics = jnp.where(take_k1, cand_k1, cand[:, 0])
        return new_metrics, take_k1

    def decode_one(ob_seq):
        # derive the init carry from the observations so it inherits
        # their device-varying type under shard_map (a bare constant is
        # replicated and trips the scan carry type check)
        init = jnp.zeros((num_states,), dtype=jnp.int32) \
            + (ob_seq[0] & 0).astype(jnp.int32)
        final_metrics, decisions = jax.lax.scan(
            forward, init, (ob_seq, allow_k1)
        )
        best = jnp.argmin(final_metrics)  # first index wins ties

        def backward(state, decision):
            bit = state >> (bits_per_state - 1)
            k = decision[state].astype(jnp.int32)
            prev = ((state << 1) & (num_states - 2)) | k
            return prev, bit

        _, bits_rev = jax.lax.scan(
            backward, best, decisions, reverse=True
        )
        return bits_rev, final_metrics[best]

    bits, metric = jax.vmap(decode_one)(obs_flat)
    return (
        bits.reshape(batch_shape + (T,)),
        metric.reshape(batch_shape),
    )


_POPCNT4 = np.array([0, 1, 1, 2], dtype=np.int64)


def viterbi_decode_np(observed, num_states: int = 16, blocked_steps: int = 0):
    """Host-side implementation with the reference's exact tie-breaking
    (k=0 wins equal metrics, lowest final state wins the final selection).
    This is the control-plane hot loop: every YSF/NXDN/D-Star frame runs
    one of these. Dispatches to the native C++ kernel when available
    (~100x the numpy path for single sequences); the numpy path below is
    the portable fallback and the batch path."""
    _check_blocked_steps(num_states, blocked_steps)
    obs_arr = np.asarray(observed, dtype=np.int64)
    if obs_arr.ndim == 1:
        from .. import native
        result = native.viterbi(obs_arr.astype(np.uint8), num_states,
                                blocked_steps)
        if result is not None:
            bits, metric = result
            return bits.astype(np.int64), np.int64(metric)

    transitions = TRANSITIONS_16 if num_states == 16 else TRANSITIONS_4
    prev_tbl, exp_tbl = _branch_tables(num_states, transitions)
    obs = np.asarray(observed, dtype=np.int64)
    T = obs.shape[-1]
    flat = obs.reshape(-1, T)
    B = flat.shape[0]

    # per-step k=1 permission mask for blocked start states
    allow_k1 = np.ones((T, num_states), dtype=bool)
    if blocked_steps:
        blocked = num_states - 1
        for t in range(min(blocked_steps, T)):
            allow_k1[t] = (np.arange(num_states) & blocked) == 0
            blocked = (blocked << 1) & (num_states - 1)

    BIG = np.int64(1 << 40)
    metrics = np.zeros((B, num_states), dtype=np.int64)
    decisions = np.zeros((T, B, num_states), dtype=np.int8)
    # dist[obs_val, state, k]
    dist_lut = _POPCNT4[
        np.arange(4)[:, None, None] ^ exp_tbl[None, :, :]]
    for t in range(T):
        dist = dist_lut[flat[:, t]]            # [B, S, 2]
        cand = metrics[:, prev_tbl.reshape(-1)].reshape(B, num_states, 2) \
            + dist
        cand1 = np.where(allow_k1[t], cand[:, :, 1], BIG)
        take1 = cand1 < cand[:, :, 0]          # strict: k=0 wins ties
        metrics = np.where(take1, cand1, cand[:, :, 0])
        decisions[t] = take1
    state = np.argmin(metrics, axis=-1)        # first index wins ties
    best_metric = metrics[np.arange(B), state]
    bits_per_state = num_states.bit_length() - 1
    out_bits = np.zeros((B, T), dtype=np.int64)
    rows = np.arange(B)
    for t in range(T - 1, -1, -1):
        out_bits[:, t] = state >> (bits_per_state - 1)
        k = decisions[t, rows, state]
        state = ((state << 1) & (num_states - 2)) | k
    return out_bits.reshape(obs.shape), best_metric.reshape(obs.shape[:-1])


def conv_encode(bits, num_states: int = 16) -> np.ndarray:
    """Encoder (TX path + test vector generation): bits [..., T] -> dibits."""
    transitions = TRANSITIONS_16 if num_states == 16 else TRANSITIONS_4
    bits_per_state = num_states.bit_length() - 1
    bits = np.asarray(bits, dtype=np.int64)
    out = np.zeros_like(bits)
    flat_b = bits.reshape(-1, bits.shape[-1])
    flat_o = out.reshape(-1, bits.shape[-1])
    for r in range(flat_b.shape[0]):
        state = 0
        for t in range(flat_b.shape[1]):
            b = int(flat_b[r, t])
            flat_o[r, t] = transitions[state][b]
            state = ((b << (bits_per_state - 1)) | (state >> 1)) & (num_states - 1)
    return flat_o.reshape(bits.shape)
