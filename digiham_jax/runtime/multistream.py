"""Multi-process channel-bank driver: one bank shard per worker process.

``MultiStreamBank`` shards a channel bank across N worker processes, each
owning ``channels/n_procs`` channels with its OWN jax client. A worker
can be lost and respawned without touching the others (``supervise``),
and host control-plane work in one worker overlaps device steps of the
others.

One card, several processes: a jax process reserves a fixed share of the
card's memory when it first uses it (three quarters by default), so a
second client on the same GPU would fail for want of memory. The bank's
budget is ``XLA_PYTHON_CLIENT_MEM_FRACTION`` as the parent's environment
holds it when the bank is built (jax's 0.75 if unset); the parent gives
each worker ``budget / n_procs`` as its own
``XLA_PYTHON_CLIENT_MEM_FRACTION``, in the worker's environment before
the worker starts, hence before jax is imported there. The parent itself
never creates a jax client: it only moves numpy blocks and bytes.

Reference anchor: the reference already scales by OS process — one
process per decoder *stage* wired with pipes (reference
examples/dmr-decoder.sh:13-29). This driver is the same operational idea
rotated 90°: one process per CHANNEL SHARD, each running the whole fused
stack (TrackedChannelBank), outputs multiplexed back to the caller.

Semantics: byte-identical to one big TrackedChannelBank — channels are
independent (pure DP), so sharding them across processes changes nothing
(tests/test_multistream.py asserts payload-byte parity). snapshot() /
restore() compose the per-worker blobs, preserving the mid-stream
checkpoint contract (runtime/checkpoint.py) across the process fan-out.

Not marshalled across workers: per-channel metadata *writers* (file
handles / fifos are process-local). Attach writers by running the
consumer on the worker side via ``worker_init`` if needed; payload bytes
and which-channel attribution flow back to the parent.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle

import numpy as np

_PROTOCOLS = ("dmr", "ysf", "nxdn", "dstar", "pocsag")


class WorkerDied(RuntimeError):
    """A MultiStreamBank worker process exited. ``worker`` is its index.

    Raised to the caller in fail-stop mode (the default); consumed
    internally by the supervisor in ``supervise=True`` mode."""

    def __init__(self, worker: int, pid, exitcode):
        self.worker = worker
        super().__init__(
            f"MultiStreamBank worker {worker} (pid {pid}) died "
            f"with exitcode {exitcode}")


def _build_bank(protocol: str, channels: int, pipeline_kwargs: dict,
                slot_filter: int, on_output):
    """Build a TrackedChannelBank for `protocol` (worker-side)."""
    from .tracked_bank import (DstarAdapter, NxdnAdapter, PocsagAdapter,
                               TrackedChannelBank, YsfAdapter)

    kw = dict(pipeline_kwargs or {})
    if protocol == "dmr":
        from ..pipeline import DmrPipeline
        kw.setdefault("sps", 10)
        pipe, adapter = DmrPipeline(channels=channels, **kw), None
    elif protocol == "ysf":
        from ..pipeline import YsfPipeline
        kw.setdefault("sps", 10)
        pipe, adapter = YsfPipeline(channels=channels, **kw), YsfAdapter()
    elif protocol == "nxdn":
        from ..pipeline import NxdnPipeline
        kw.setdefault("sps", 20)
        pipe, adapter = NxdnPipeline(channels=channels, **kw), NxdnAdapter()
    elif protocol == "dstar":
        from ..pipeline import FskPipeline
        pipe, adapter = (FskPipeline(channels=channels, protocol="dstar",
                                     **kw), DstarAdapter())
    elif protocol == "pocsag":
        from ..pipeline import FskPipeline
        pipe, adapter = (FskPipeline(channels=channels, protocol="pocsag",
                                     **kw), PocsagAdapter())
    else:
        raise ValueError(
            f"unknown protocol {protocol!r} (one of {_PROTOCOLS})")
    return TrackedChannelBank(pipe, on_output=on_output,
                              slot_filter=slot_filter, adapter=adapter)


def _worker(conn, protocol, channels, pipeline_kwargs, slot_filter,
            worker_init):
    """Worker process body: own jax client, one bank shard, RPC loop."""
    # persistent compile cache: without it every worker pays the full
    # compile on every process launch. CPU workers must NOT share it: a
    # cache hit vs a fresh compile can change XLA:CPU's f32 accumulation
    # order, seen as one-dibit knife-edge flips that broke byte-identity
    # between otherwise identical runs.
    if not os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        from ..utils import enable_compilation_cache

        enable_compilation_cache()
    outputs = []
    bank = _build_bank(protocol, channels, pipeline_kwargs, slot_filter,
                       on_output=lambda c, d: outputs.append((c, bytes(d))))
    if worker_init is not None:
        worker_init(bank)
    try:
        while True:
            msg = conn.recv()
            op = msg[0]
            if op == "push":
                bank.push(msg[1])
                conn.send(outputs)
                outputs = []
            elif op == "flush":
                bank.flush()
                conn.send(outputs)
                outputs = []
            elif op == "snapshot":
                conn.send(bank.snapshot())
            elif op == "restore":
                bank.restore(msg[1])
                conn.send(None)
            elif op == "close":
                conn.send(None)
                return
    except (EOFError, KeyboardInterrupt):
        return


class MultiStreamBank:
    """N-process sharded TrackedChannelBank (see module docstring).

    protocol: one of dmr/ysf/nxdn/dstar/pocsag.
    channels: total channel count; must divide by n_procs.
    n_procs: worker process count.
    on_output(channel, payload): called in the parent with GLOBAL channel
        ids, in worker order then emission order (per-channel ordering is
        preserved; cross-channel ordering between shards is not defined,
        matching the reference's independent per-channel processes).
    pipeline_kwargs: forwarded to the protocol pipeline per shard
        (e.g. n_centuries).
    worker_init(bank): optional callable run once in each worker after
        bank construction (attach meta writers, warm caches). Must be
        picklable (module-level function).
    supervise: False (default) = fail-stop — a dead worker raises
        WorkerDied and the bank is unusable (the reference's semantics:
        a dead pipeline stage kills the shell pipeline). True = elastic:
        a dead worker is respawned, restored from the last parent-held
        composite snapshot, and the sample blocks pushed since are
        replayed with already-emitted bytes suppressed — the caller's
        output stream stays byte-identical (SURVEY §5 failure-detection/
        elastic-recovery at the process level).
    replay_limit: supervised mode re-snapshots every this-many pushes,
        bounding both parent memory and respawn replay cost.

    Each worker's share of the card's memory comes from the environment
    (module docstring).
    """

    def __init__(self, protocol: str = "dmr", channels: int = 256,
                 n_procs: int = 4, on_output=None, slot_filter: int = 3,
                 pipeline_kwargs: dict | None = None, worker_init=None,
                 supervise: bool = False, replay_limit: int = 8):
        if channels % n_procs:
            raise ValueError(
                f"{channels} channels not divisible by {n_procs} workers")
        self.protocol = protocol
        self.channels = channels
        self.n_procs = n_procs
        self.on_output = on_output
        self._per = channels // n_procs
        self._spawn_args = (protocol, self._per, pipeline_kwargs,
                            slot_filter, worker_init)
        self.worker_mem_fraction = float(os.environ.get(
            "XLA_PYTHON_CLIENT_MEM_FRACTION", "0.75")) / n_procs
        self._ctx = mp.get_context("spawn")  # fresh CPython => fresh jax
        self._conns = [None] * n_procs
        self._procs = [None] * n_procs
        for w in range(n_procs):
            self._spawn(w)
        # -- supervision (opt-in elastic recovery; fail-stop otherwise) --
        # Parent-held recovery state: the last composite snapshot's
        # per-worker shards, the sample blocks pushed since, and how many
        # output bytes each channel already emitted since that snapshot
        # (replay after a respawn re-produces those bytes; the counters
        # suppress them so the caller-visible stream stays byte-identical).
        self.supervise = supervise
        self.replay_limit = replay_limit
        self._base_shards = None
        self._replay = []
        self._emitted = [[0] * self._per for _ in range(n_procs)]
        if supervise:
            self._base_shards = self._snapshot_shards()

    def _spawn(self, w: int) -> None:
        """(Re)start worker w; replaces its pipe + process slot."""
        parent, child = self._ctx.Pipe()
        p = self._ctx.Process(target=_worker,
                              args=(child, *self._spawn_args), daemon=True)
        # a spawned child copies the parent's environment at start, so
        # this is in place before the child imports anything
        key = "XLA_PYTHON_CLIENT_MEM_FRACTION"
        saved = os.environ.get(key)
        os.environ[key] = f"{self.worker_mem_fraction:.4f}"
        try:
            p.start()
        finally:
            if saved is None:
                del os.environ[key]
            else:
                os.environ[key] = saved
        child.close()
        if self._conns[w] is not None:
            try:
                self._conns[w].close()
            except OSError:
                pass
        self._conns[w] = parent
        self._procs[w] = p

    # -- core ------------------------------------------------------------
    def _send(self, w, msg):
        try:
            self._conns[w].send(msg)
        except (BrokenPipeError, OSError) as e:
            proc = self._procs[w]
            raise WorkerDied(w, proc.pid, proc.exitcode) from e

    def _recv(self, w):
        """recv from worker w, failing loudly if it died (a bare recv
        would block forever on a crashed worker's half-open pipe)."""
        conn, proc = self._conns[w], self._procs[w]
        while not conn.poll(1.0):
            if not proc.is_alive():
                raise WorkerDied(w, proc.pid, proc.exitcode)
        try:
            return conn.recv()
        except (EOFError, ConnectionResetError, OSError):
            raise WorkerDied(w, proc.pid, proc.exitcode) from None

    def _emit(self, w, outs):
        """Dispatch one worker's outputs with global channel ids,
        keeping the since-snapshot byte accounting current."""
        for local_ch, payload in outs:
            self._emitted[w][local_ch] += len(payload)
            if self.on_output is not None:
                self.on_output(w * self._per + local_ch, payload)

    def _gather(self):
        """Collect one reply per worker; dispatch outputs with global ids."""
        for w in range(self.n_procs):
            self._emit(w, self._recv(w))

    def _shard_msg(self, msg, w):
        """Per-worker view of a broadcast message (push carries the full
        [channels, L] block; each worker gets only its channel rows)."""
        if msg[0] == "push":
            return ("push", msg[1][w * self._per:(w + 1) * self._per])
        return msg

    def _roundtrip(self, msg) -> None:
        """Send msg to every worker, then gather — the supervised path
        recovers any worker that dies at either end; fail-stop re-raises."""
        dead = []
        for w in range(self.n_procs):
            try:
                self._send(w, self._shard_msg(msg, w))
            except WorkerDied:
                if not self.supervise:
                    raise
                dead.append(w)
        for w in range(self.n_procs):
            if w in dead:
                continue
            try:
                self._emit(w, self._recv(w))
            except WorkerDied:
                if not self.supervise:
                    raise
                dead.append(w)
        for w in dead:
            self._recover(w, tail_msg=msg if msg[0] == "flush" else None)

    def push(self, samples: np.ndarray) -> None:
        """Feed [channels, L] float samples; all shards run CONCURRENTLY
        (this is the overlap the driver exists for)."""
        samples = np.asarray(samples)
        if samples.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} rows, got {samples.shape[0]}")
        if self.supervise:
            if len(self._replay) >= self.replay_limit:
                self._rebase()
            self._replay.append(samples)
        self._roundtrip(("push", samples))

    def flush(self) -> None:
        self._roundtrip(("flush",))

    def prewarm(self, block: int = 16384) -> None:
        """Absorb the first-execution stall at startup instead of on the
        first real push: push one silence block of the production size
        through every worker (forcing compile + device-side executable
        install), then roll the bank back
        to its pre-push state. Invisible to the caller: outputs from the
        dummy block are suppressed and the snapshot/restore round-trip
        makes the state change un-happen (asserted byte-identical in
        tests/test_multistream.py). ``block`` should match the real
        push size — the compiled step is shape-specific."""
        snap = self.snapshot()
        saved, self.on_output = self.on_output, None
        try:
            self.push(np.zeros((self.channels, int(block)), np.float32))
        finally:
            self.on_output = saved
            self.restore(snap)

    # -- supervision --------------------------------------------------------
    def _snapshot_shards(self) -> list:
        """One shard blob per worker. Supervised mode is fault-aware: a
        worker dying mid-snapshot is recovered (replaying the current
        buffer) and re-asked, PER WORKER — naive retry would re-send the
        snapshot request to healthy workers whose replies are already
        queued, desyncing the pipe protocol (caught by the SIGKILL test)."""
        if not self.supervise:
            for w in range(self.n_procs):
                self._send(w, ("snapshot",))
            return [self._recv(w) for w in range(self.n_procs)]
        shards = [None] * self.n_procs
        dead = []
        for w in range(self.n_procs):
            try:
                self._send(w, ("snapshot",))
            except WorkerDied:
                dead.append(w)
        for w in range(self.n_procs):
            if w in dead:
                continue
            try:
                shards[w] = self._recv(w)
            except WorkerDied:
                dead.append(w)
        for w in dead:
            self._recover(w)  # replay brings it to the current position
            self._send(w, ("snapshot",))
            shards[w] = self._recv(w)
        return shards

    def _rebase(self) -> None:
        """Fold the replay buffer into a fresh composite snapshot (bounds
        parent memory and respawn replay cost to ``replay_limit`` blocks)."""
        self._base_shards = self._snapshot_shards()
        self._replay = []
        self._emitted = [[0] * self._per for _ in range(self.n_procs)]

    def _recover(self, w: int, tail_msg=None) -> None:
        """Supervised respawn: restart worker w, restore its shard from
        the last composite snapshot, replay every sample block pushed
        since, and re-emit only the output bytes the caller has not seen
        (byte-identical continuation — tests/test_multistream.py kills a
        worker mid-stream and asserts stream equality).

        tail_msg: a non-push message (flush) the worker died on; re-sent
        after the replay brings its state back to the pre-flush point.

        Caveat: worker-side meta writers attached via ``worker_init`` see
        replayed blocks again; supervision is designed for payload-output
        deployments (or idempotent writers)."""
        lo, hi = w * self._per, (w + 1) * self._per
        self._spawn(w)
        self._send(w, ("restore", self._base_shards[w]))
        self._recv(w)
        emitted = self._emitted[w]
        seen = [0] * self._per
        for block in self._replay:
            self._send(w, ("push", np.asarray(block)[lo:hi]))
            for local_ch, payload in self._recv(w):
                start = seen[local_ch]
                end = start + len(payload)
                seen[local_ch] = end
                if end > emitted[local_ch]:
                    fresh = payload[max(0, emitted[local_ch] - start):]
                    emitted[local_ch] = end
                    if self.on_output is not None:
                        self.on_output(lo + local_ch, fresh)
        if tail_msg is not None:
            self._send(w, tail_msg)
            self._emit(w, self._recv(w))

    # -- checkpoint contract ----------------------------------------------
    def snapshot(self) -> bytes:
        """Composite mid-stream checkpoint: one blob per worker shard."""
        return pickle.dumps({
            "protocol": self.protocol,
            "channels": self.channels,
            "n_procs": self.n_procs,
            "shards": self._snapshot_shards(),
        })

    def restore(self, blob: bytes) -> None:
        d = pickle.loads(blob)
        if (d.get("protocol", self.protocol), d["channels"],
                d["n_procs"]) != (self.protocol, self.channels,
                                  self.n_procs):
            raise ValueError(
                f"snapshot is {d.get('protocol')}/{d['channels']}ch/"
                f"{d['n_procs']}proc, bank is {self.protocol}/"
                f"{self.channels}ch/{self.n_procs}proc")
        for w, shard in enumerate(d["shards"]):
            self._send(w, ("restore", shard))
        for w in range(self.n_procs):
            self._recv(w)
        if self.supervise:  # the restored state is the new recovery base
            self._base_shards = list(d["shards"])
            self._replay = []
            self._emitted = [[0] * self._per for _ in range(self.n_procs)]

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("close",))
            except (BrokenPipeError, OSError):
                pass
        for conn in self._conns:
            try:
                conn.recv()
            except (EOFError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        for conn in self._conns:
            conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
