"""The GPU century demodulator (ops/demod_triton.py) in interpret mode.

The kernel only reorders float sums, so on every input here its symbol
decisions, read positions and slews must equal the plain ``lax.scan``
(``_demod_block_xla``) and the per-symbol host oracles. The Triton
lowering itself is checked by verifying the module it emits for CUDA —
no GPU needed — and the kernel choice by stubbing the backend.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from digiham_jax.dsp import demod as demod_mod
from digiham_jax.dsp.demod import (DemodState, FskDemodNp, GfskDemodNp,
                                   _agc_slice_block, _demod_block_gpu,
                                   _demod_block_xla, _sliding_minmax_100,
                                   demod_init, fsk_demod_block,
                                   gfsk_demod_block, use_gpu_kernel)

from test_dsp import synth_2fsk, synth_4fsk

MODES = [("gfsk", False), ("fsk", False), ("fsk", True)]


def _noise(C, L, seed, scale=500.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray((rng.standard_normal((C, L)) * scale)
                       .astype(np.float32))


def _block_len(nc, sps, slack=0):
    return nc * (100 * sps + 1) + 2 * sps + slack


def _state(C, seed, pos=None, offset=None):
    rng = np.random.default_rng(seed)
    pos = np.zeros(C, np.int32) if pos is None else np.asarray(pos)
    offset = np.zeros(C, np.int32) if offset is None else np.asarray(offset)
    ring = (rng.standard_normal((C, 100)) * 300).astype(np.float32)
    return DemodState(jnp.asarray(pos, jnp.int32),
                      jnp.asarray(offset, jnp.int32), jnp.asarray(ring))


def _assert_same(got, want):
    (sym_g, st_g), (sym_w, st_w) = got, want
    np.testing.assert_array_equal(np.asarray(sym_g), np.asarray(sym_w))
    np.testing.assert_array_equal(np.asarray(st_g.pos), np.asarray(st_w.pos))
    np.testing.assert_array_equal(np.asarray(st_g.offset),
                                  np.asarray(st_w.offset))
    np.testing.assert_allclose(np.asarray(st_g.volume_ring),
                               np.asarray(st_w.volume_ring),
                               rtol=1e-5, atol=1e-3)


def _both(x, st, nc, sps, mode, invert):
    return (_demod_block_gpu(x, st, nc, sps, mode, invert, interpret=True),
            _demod_block_xla(x, st, nc, sps, mode, invert))


@pytest.mark.parametrize("sps", [10, 20, 40])
@pytest.mark.parametrize("mode,invert", MODES,
                         ids=["gfsk", "fsk", "fsk-invert"])
def test_kernel_matches_scan(sps, mode, invert):
    nc, C = 2, 3
    x = _noise(C, _block_len(nc, sps), seed=sps)
    st = _state(C, seed=sps, pos=[0, 3, sps], offset=[0, 1, -1])
    _assert_same(*_both(x, st, nc, sps, mode, invert))


@pytest.mark.parametrize("C", [1, 5, 9])
def test_channel_counts_not_power_of_two(C):
    """One program per channel: any channel count, no tile divisibility."""
    nc, sps = 2, 10
    x = _noise(C, _block_len(nc, sps), seed=C)
    _assert_same(*_both(x, demod_init(C), nc, sps, "gfsk", False))


@pytest.mark.parametrize("pos", [0, 1, 9, 19, 37])
def test_pos_near_block_start(pos):
    nc, sps, C = 2, 10, 2
    x = _noise(C, _block_len(nc, sps, slack=40), seed=pos)
    st = _state(C, seed=pos, pos=[pos, pos // 2])
    _assert_same(*_both(x, st, nc, sps, "gfsk", False))


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_pending_slew_applies_to_symbols_after_the_first(offset):
    nc, sps, C = 1, 20, 2
    x = _noise(C, _block_len(nc, sps), seed=offset + 5)
    st = _state(C, seed=1, pos=[2, 5], offset=[offset, offset])
    _assert_same(*_both(x, st, nc, sps, "fsk", False))


@pytest.mark.parametrize("sps", [10, 20, 40])
def test_kernel_matches_gfsk_oracle(sps):
    rng = np.random.default_rng(sps)
    n_sym = 320
    sig = synth_4fsk(rng.integers(0, 4, n_sym), sps, noise=0.05, seed=sps)
    oracle = GfskDemodNp(sps, precision="f32")
    want = oracle.process(sig)
    nc = len(want) // 100
    got, _ = _demod_block_gpu(jnp.asarray(sig)[None, :], demod_init(1), nc,
                              sps, "gfsk", False, interpret=True)
    np.testing.assert_array_equal(np.asarray(got)[0], want[:nc * 100])


@pytest.mark.parametrize("invert", [False, True])
def test_kernel_matches_fsk_oracle(invert):
    sps = 40
    rng = np.random.default_rng(7)
    sig = synth_2fsk(rng.integers(0, 2, 250), sps)
    want = FskDemodNp(sps, invert=invert, precision="f32").process(sig)
    nc = len(want) // 100
    got, _ = _demod_block_gpu(jnp.asarray(sig)[None, :], demod_init(1), nc,
                              sps, "fsk", invert, interpret=True)
    np.testing.assert_array_equal(np.asarray(got)[0], want[:nc * 100])


def test_streaming_carry_chains_blocks():
    """Two chained blocks (pos carried, rebased by the caller) equal one
    block over the same samples."""
    sps, C = 10, 2
    x = _noise(C, _block_len(4, sps), seed=11)
    one, st_one = _demod_block_gpu(x, demod_init(C), 4, sps, "gfsk", False,
                                   interpret=True)
    a, st = _demod_block_gpu(x, demod_init(C), 2, sps, "gfsk", False,
                             interpret=True)
    b, st = _demod_block_gpu(x, st, 2, sps, "gfsk", False, interpret=True)
    np.testing.assert_array_equal(np.concatenate([a, b], axis=1),
                                  np.asarray(one))
    np.testing.assert_array_equal(np.asarray(st.pos), np.asarray(st_one.pos))


def test_agc_slice_block_matches_per_century_reference():
    """The block-wide AGC + slicer equals the per-century form the scan
    computes (the previous century's volumes seed each window)."""
    rng = np.random.default_rng(3)
    C, nc = 2, 3
    ring = jnp.asarray(rng.normal(0, 1, (C, 100)).astype(np.float32))
    vols = jnp.asarray(rng.normal(0, 1, (C, nc, 100)).astype(np.float32))
    mids = jnp.asarray(rng.normal(0, 1, (C, nc, 100)).astype(np.float32))
    sym, new_ring = _agc_slice_block(ring, vols, mids, "gfsk", False)
    for c in range(C):
        prev = ring[c]
        for k in range(nc):
            wmin, wmax = _sliding_minmax_100(
                jnp.concatenate([prev, vols[c, k]]))
            want = demod_mod._slice(mids[c, k], wmin, wmax, "gfsk", False)
            np.testing.assert_array_equal(
                np.asarray(sym[c, k * 100:(k + 1) * 100]), np.asarray(want))
            prev = vols[c, k]
    np.testing.assert_array_equal(np.asarray(new_ring),
                                  np.asarray(vols[:, -1]))


def test_sliding_minmax_batches_over_leading_axes():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 2, 200)).astype(np.float32)
    wmin, wmax = _sliding_minmax_100(jnp.asarray(x))
    for i in range(100):
        win = x[..., i + 1:i + 101]
        np.testing.assert_array_equal(np.asarray(wmin)[..., i],
                                      win.min(-1))
        np.testing.assert_array_equal(np.asarray(wmax)[..., i],
                                      win.max(-1))


@pytest.mark.parametrize("backend,impl,want", [
    ("gpu", "auto", True), ("gpu", "xla", False),
    ("cpu", "auto", False), ("cpu", "xla", False)])
def test_kernel_choice(monkeypatch, backend, impl, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert use_gpu_kernel(impl) is want


def test_unknown_impl_is_refused():
    with pytest.raises(ValueError):
        use_gpu_kernel("gspmd")


def test_public_entry_points_take_the_scan_off_gpu():
    """On the CPU, impl="auto" is the plain scan: bit-identical to it."""
    sps, nc, C = 10, 2, 2
    x = _noise(C, _block_len(nc, sps), seed=21)
    st = demod_init(C)
    _assert_same(gfsk_demod_block(x, st, nc, sps),
                 _demod_block_xla(x, st, nc, sps, "gfsk", False))
    _assert_same(fsk_demod_block(x, st, nc, sps, True),
                 _demod_block_xla(x, st, nc, sps, "fsk", True))


@pytest.mark.parametrize("sps", [10, 20, 40])
def test_triton_module_verifies_at_full_width(sps):
    """Lower the kernel for CUDA at the 256-channel x 16-century width
    and verify the Triton module it emits. This catches type errors the
    GPU compiler would refuse (e.g. a select whose branches disagree)
    without a GPU."""
    from jax._src.pallas.triton import lowering as tl

    from digiham_jax.ops.demod_triton import century_stats

    modules = []
    orig = tl.lower_jaxpr_to_triton_module

    def capture(*args, **kwargs):
        result = orig(*args, **kwargs)
        modules.append(result.module)
        return result

    tl.lower_jaxpr_to_triton_module = capture
    try:
        f = jax.jit(lambda x, p, o: century_stats(x, p, o, 16, sps))
        L = _block_len(16, sps)
        f.trace(jax.ShapeDtypeStruct((256, L), jnp.float32),
                jax.ShapeDtypeStruct((256,), jnp.int32),
                jax.ShapeDtypeStruct((256,), jnp.int32)).lower(
                    lowering_platforms=("cuda",))
    finally:
        tl.lower_jaxpr_to_triton_module = orig
    assert len(modules) == 1
    modules[0].operation.verify()
