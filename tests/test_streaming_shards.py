"""Time-sharded STREAMING equivalence: the ppermute carry chain.

Proves the contract VERDICT.md round-1 item 1 (and round-2 item 3)
demands: a time-sharded stream — multiple consecutive sharded steps —
produces byte-identical symbols / sync distances / frame fields to the
single-device pipeline stream (driven through ChannelBank, the
production consume/rebase path), for 2 and 4 time shards, for ALL FIVE
protocols, with the demod carry (pos / slew / volume ring) hopping
shard-to-shard over ``ppermute``.
"""
import numpy as np
import pytest

import jax

from digiham_jax.parallel import make_mesh
from digiham_jax.parallel.streaming import (
    TimeShardedDmrPipeline,
    TimeShardedDmrStream,
    TimeShardedPipeline,
    TimeShardedStream,
    _protocol_config,
)
from digiham_jax.pipeline.dmr import DmrPipeline
from digiham_jax.runtime.channel_bank import ChannelBank

FRAME = 144
SYNC = 24


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return devs


def _single_device_pipeline(protocol, C, n_centuries):
    """The byte-identity reference: each protocol's production pipeline."""
    if protocol == "dmr":
        return DmrPipeline(channels=C, sps=10, n_centuries=n_centuries)
    if protocol == "ysf":
        from digiham_jax.pipeline.ysf import YsfPipeline
        return YsfPipeline(channels=C, sps=10, n_centuries=n_centuries)
    if protocol == "nxdn":
        from digiham_jax.pipeline.nxdn import NxdnPipeline
        return NxdnPipeline(channels=C, sps=20, n_centuries=n_centuries)
    from digiham_jax.pipeline.fsk import FskPipeline
    return FskPipeline(C, protocol, n_centuries=n_centuries)


def _bank_reference(x, protocol, C, cps):
    """Single-device reference stream via the production ChannelBank
    (variable consumption keeps pos >= 0; n_centuries=cps keeps every
    block start on the global frame grid)."""
    bank = ChannelBank(_single_device_pipeline(protocol, C, cps),
                       [None] * C)
    results = bank.push(x)
    dibits = np.concatenate(
        [np.asarray(r["dibits"]) for r in results], axis=1)
    sync_keys = [k for k in results[0] if k.startswith("sync_dist")]
    fields = {}
    for k in results[0]:
        if k == "dibits" or k in sync_keys:
            continue
        fields[k] = np.concatenate(
            [np.asarray(r[k]) for r in results], axis=1)
    # sync windows per block are block-local (each block misses its own
    # sync_len-1 boundary windows); keep (global_start, array) pairs
    block_sym = cps * 100
    syncs = {k: [(b * block_sym, np.asarray(r[k]))
                 for b, r in enumerate(results)] for k in sync_keys}
    return dibits, fields, syncs


def _run_and_compare(protocol, n_time, use_rrc, n_steps, seed, cps=None):
    C = 2
    cfg = _protocol_config(protocol)
    cps = cps or cfg.default_cps
    mesh = make_mesh(n_channel_shards=2, n_time_shards=n_time)
    sp = TimeShardedPipeline(mesh, channels=C, protocol=protocol,
                             centuries_per_shard=cps, use_rrc=use_rrc)
    B, S = sp.block_len, sp.symbols_per_block
    seg_sym = sp.seg_symbols

    rng = np.random.default_rng(seed)
    total = n_steps * B + sp.h_right + 1200
    x = rng.normal(0, 1000, (C, total)).astype(np.float32)

    driver = TimeShardedStream(sp)
    outs = driver.push(x)
    assert len(outs) == n_steps
    got_dib = np.concatenate(
        [np.asarray(o["dibits"]) for o in outs], axis=1)
    sync_keys = [s.name for s in cfg.syncs]
    got_sync = {k: np.concatenate([np.asarray(o[k]) for o in outs], axis=1)
                for k in sync_keys}
    got_fields = {}
    for k in outs[0]:
        if k == "dibits" or k in sync_keys:
            continue
        got_fields[k] = np.concatenate(
            [np.asarray(o[k]) for o in outs], axis=1)

    # the single-device reference pipeline always runs its RRC stage;
    # use_rrc=False isolates the sharded carry chain, so compare against
    # an RRC-free single-device pipe only for protocols that support it
    if not use_rrc and cfg.design is not None:
        # this RRC-free reference is only wired for DMR; extending
        # carry-chain-isolation coverage to other protocols must add
        # the matching single-device pipe here, not silently compare
        # against the wrong decoder
        assert protocol == "dmr", protocol
        want_pipe = DmrPipeline(channels=C, sps=10, n_centuries=cps,
                                use_rrc=False)
        bank = ChannelBank(want_pipe, [None] * C)
        results = bank.push(x)
        want_dib = np.concatenate(
            [np.asarray(r["dibits"]) for r in results], axis=1)
        want_fields = {}
        for k in results[0]:
            if k in ("dibits", "sync_dist_dense"):
                continue
            want_fields[k] = np.concatenate(
                [np.asarray(r[k]) for r in results], axis=1)
        want_syncs = {"sync_dist_dense":
                      [(b * cps * 100, np.asarray(r["sync_dist_dense"]))
                       for b, r in enumerate(results)]}
    else:
        want_dib, want_fields, want_syncs = _bank_reference(
            x, protocol, C, cps)

    n = min(got_dib.shape[1], want_dib.shape[1])
    assert n >= n_steps * S - n_time * seg_sym
    np.testing.assert_array_equal(got_dib[:, :n], want_dib[:, :n])

    if cfg.frame_size:
        nf = n // cfg.frame_size
        for k, want in want_fields.items():
            np.testing.assert_array_equal(
                got_fields[k][:, :nf], want[:, :nf], err_msg=f"field {k}")

    # sync windows: compare wherever both sides have a valid window.
    # sharded marks only each step's global tail invalid; the bank
    # reference misses the boundary windows of each of its own blocks.
    for spec in cfg.syncs:
        got = got_sync[spec.name]
        for start, arr in want_syncs[spec.name]:
            width = arr.shape[1]
            stop = min(start + width, got.shape[1] - (spec.length - 1))
            if stop <= start:
                break
            # drop windows invalidated at each sharded-step tail
            step_end = ((start // S) + 1) * S
            stop = min(stop, step_end - (spec.length - 1))
            if stop <= start:
                continue
            np.testing.assert_array_equal(
                got[:, start:stop], arr[:, :stop - start],
                err_msg=f"{spec.name} window block @{start}")


@pytest.mark.parametrize("n_time", [2, 4])
def test_streamed_time_shards_bitexact(devices, n_time):
    """Full DMR pipeline (RRC included), 2 consecutive sharded steps,
    via the backward-compatible DMR-specific classes."""
    C, cps = 2, 36
    mesh = make_mesh(n_channel_shards=2, n_time_shards=n_time)
    sp = TimeShardedDmrPipeline(mesh, channels=C, sps=10,
                                centuries_per_shard=cps, use_rrc=True)
    rng = np.random.default_rng(42)
    total = 2 * sp.block_len + sp.h_right + 1200
    x = rng.normal(0, 1000, (C, total)).astype(np.float32)
    driver = TimeShardedDmrStream(sp)
    outs = driver.push(x)
    assert len(outs) == 2
    want_dib, _, _ = _bank_reference(x, "dmr", C, cps)
    got_dib = np.concatenate(
        [np.asarray(o["dibits"]) for o in outs], axis=1)
    n = min(got_dib.shape[1], want_dib.shape[1])
    np.testing.assert_array_equal(got_dib[:, :n], want_dib[:, :n])


def test_streamed_time_shards_no_rrc(devices):
    """Pure carry-chain isolation: no filter stage, 4 shards, 3 steps
    (the third step starts channels at origins the drift has parted)."""
    _run_and_compare("dmr", 4, use_rrc=False, n_steps=3, seed=7, cps=36)


@pytest.mark.parametrize("n_time", [2, 4])
@pytest.mark.parametrize("protocol",
                         ["dmr", "ysf", "nxdn", "dstar", "pocsag"])
def test_streamed_time_shards_all_protocols(devices, protocol, n_time):
    """VERDICT round-2 item 3: the exact streaming carry chain for all
    five protocols — full pipeline (RRC where the protocol has one),
    2 and 4 time shards, 2 consecutive steps, byte-identical to the
    single-device production stream."""
    _run_and_compare(protocol, n_time, use_rrc=True, n_steps=2,
                     seed=100 + n_time)
