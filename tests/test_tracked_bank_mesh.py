"""Mesh-sharded TrackedChannelBank: the production 256-channel topology
in miniature — every device call channel-sharded over the virtual mesh,
outputs byte- and event-identical to the unsharded bank and to the
per-channel symbol-domain reference decoder."""
import numpy as np
import pytest

import jax

from digiham_jax.parallel import make_mesh
from digiham_jax.pipeline import DmrPipeline
from digiham_jax.runtime.meta import PipelineMetaWriter
from digiham_jax.runtime.tracked_bank import TrackedChannelBank

from test_tracked_bank import LEVELS, make_streams, reference_path
from dmr_synth import voice_frame


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return make_mesh(n_channel_shards=4, n_time_shards=2)


def _bank(C, mesh=None):
    pipe = DmrPipeline(channels=C, sps=10, n_centuries=2)
    outputs = {c: b"" for c in range(C)}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: outputs.__setitem__(
            c, outputs[c] + d), mesh=mesh)
    metas = []
    for c in range(C):
        events = []
        bank.set_meta_writer(c, PipelineMetaWriter(
            lambda b, ev=events: ev.append(b.decode())))
        metas.append(events)
    return bank, outputs, metas


@pytest.mark.parametrize("seed", range(4))
def test_dibit_contract_on_mesh(mesh, seed):
    """Same contract as test_exact_equivalence_on_dibits, mesh-sharded."""
    streams = make_streams(seed, n_channels=4)
    bank, outputs, metas = _bank(4, mesh=mesh)
    for lo in range(0, streams.shape[1], 800):
        bank.push_dibits(streams[:, lo:lo + 800])
    ref_out, ref_meta = reference_path(streams)
    for c in range(4):
        assert outputs[c] == ref_out[c], f"ch{c} payload diverges"
        assert "".join(metas[c]) == ref_meta[c], f"ch{c} metadata diverges"


def test_sample_path_mesh_equals_unsharded(mesh):
    """Full sample path (RRC+demod+decode on device): mesh-sharded bank
    must emit the same bytes and events as the unsharded bank."""
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 4, 108)
    frames = [voice_frame(s % 2, payload, sync=True) for s in range(12)]
    dibits = np.concatenate([np.zeros(30, np.uint8)] + frames)
    base = np.repeat(LEVELS[dibits], 10) * 1000
    samples = np.stack([base + rng.normal(0, 40, base.shape)
                        for _ in range(4)]).astype(np.float32)

    got = {}
    for m in (None, mesh):
        bank, outputs, metas = _bank(4, mesh=m)
        for lo in range(0, samples.shape[1], 8192):
            bank.push(samples[:, lo:lo + 8192])
        got[m is not None] = (dict(outputs), ["".join(e) for e in metas])
    assert got[True] == got[False]
    assert any(got[True][0].values())  # decoded something


def test_snapshot_restore_on_mesh(mesh):
    streams = make_streams(1, n_channels=4)
    bank, outputs, metas = _bank(4, mesh=mesh)
    half = streams.shape[1] // 2
    bank.push_dibits(streams[:, :half])
    blob = bank.snapshot()

    bank2, outputs2, metas2 = _bank(4, mesh=mesh)
    bank2.restore(blob)
    pre = {c: len(outputs[c]) for c in outputs}
    bank.push_dibits(streams[:, half:])
    bank2.push_dibits(streams[:, half:])
    for c in outputs:
        assert outputs[c][pre[c]:] == outputs2[c]


def test_mesh_bank_steps_plain_xla(mesh):
    """The mesh bank's pipeline step runs under GSPMD (jit +
    NamedSharding), which cannot partition the GPU demod kernel's custom
    call — the bank must step with impl="xla"; the one-device bank keeps
    the default. A spy pipeline records the impl of every step."""
    impls = []

    class SpyPipeline(DmrPipeline):
        def step(self, samples, state, impl=None):
            impls.append(impl)
            return super().step(samples, state, impl=impl)

    C = 4
    noise = np.random.default_rng(3).normal(0, 0.3, (C, 4200)).astype(
        np.float32)
    for use_mesh, want in ((None, None), (mesh, "xla")):
        impls.clear()
        bank = TrackedChannelBank(
            SpyPipeline(channels=C, sps=10, n_centuries=2),
            mesh=use_mesh)
        bank.push(noise)
        assert impls and set(impls) == {want}, (use_mesh, impls)


def test_nxdn_mesh_equals_unsharded(mesh):
    """NXDN mesh bank (narrow-RRC plain-XLA step + SACCH/FACCH1 Viterbi
    in the batched field decode) emits bytes and events identical to the
    unsharded bank."""
    from digiham_jax.pipeline import NxdnPipeline
    from digiham_jax.runtime.tracked_bank import NxdnAdapter

    from test_tracked_bank_nxdn import make_streams as nxdn_streams

    streams = nxdn_streams(1, n_channels=4)

    got = {}
    for m in (None, mesh):
        outputs = {c: b"" for c in range(4)}
        bank = TrackedChannelBank(
            NxdnPipeline(channels=4, sps=20, n_centuries=3),
            adapter=NxdnAdapter(), mesh=m,
            on_output=lambda c, d: outputs.__setitem__(
                c, outputs[c] + d))
        metas = []
        for c in range(4):
            events = []
            bank.set_meta_writer(c, PipelineMetaWriter(
                lambda b, ev=events: ev.append(b.decode())))
            metas.append(events)
        for lo in range(0, streams.shape[1], 800):
            bank.push_dibits(streams[:, lo:lo + 800])
        got[m is not None] = (dict(outputs), ["".join(e) for e in metas])
    assert got[True] == got[False]
    assert any(len(v) > 0 for v in got[False][0].values())
