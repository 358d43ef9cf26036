"""Rank 0 drives, the other ranks follow.

The JAX package serves a mesh from one controller. The port's
tensor-parallel engine is one process a rank, and every rank must make the
same engine calls in the same order, or the next collective deadlocks. So
rank 0 runs everything from the app down to the scheduler, as one device
does, and the other ranks only mirror its engine:

- On rank 0 (``Leader``), every engine method that changes device state
  (``FORWARDED``) first sends its name and arguments to the other ranks,
  then runs locally. A call made inside another forwarded call (``prefill``
  calls ``prefill_batch``, which calls ``prefill_chunk``) is not sent again:
  the followers make it inside the same outer call. One lock keeps the
  calls of several threads (the event loop, the breaker's rebuild) whole
  and in one order.
- The channel is a CPU gloo group of its own: one pickled object broadcast
  a call. The call's tensor arguments (a logits row, a session record)
  travel on the mesh's ``"world"`` group (every rank of the mesh: with
  ``seq > 1`` the ``model`` group holds only one seq coordinate's ranks),
  by broadcast from rank 0, and arrive on each rank's device.
- Every other rank runs ``follow``: it executes each call on its own shard
  and discards the results (every rank computes the same tokens).
- A stop message ends the loop. So does the channel's error when rank 0 is
  gone: its socket closes, or the group's timeout runs out. Rank 0 sends a
  heartbeat when idle, so an idle app never times its followers out. No
  rank outlives rank 0.
- A follower that dies (an OOM, an exception in ``follow``) is seen by
  rank 0 within ``WATCH_S``: the leader's heartbeat thread asks its
  ``watch`` (``RankGroup.down``: the follower processes' exit codes), and
  from then on every forwarded call raises ``RankDown`` at once instead of
  blocking in a collective until the group's timeout; the app answers
  with its retryable not-ready error (``serve/app``).
- ``spawn_followers`` starts ranks 1.. as processes (spawn context, daemon)
  that each build their own engine on their device from the same config
  (the same seed or checkpoint, cut to their shard); ``RankGroup.close``
  stops and joins them.
"""

from __future__ import annotations

import datetime
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch

from finchat_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# how often rank 0 looks for a dead follower (seconds)
WATCH_S = 0.5


class RankDown(RuntimeError):
    """A rank of the group is gone: the engine cannot make another call."""

# the engine methods that change device state: the scheduler's, the session
# tier's (offload, restore), the breaker's (rebuild) and warmup
FORWARDED = (
    "set_page_table_row", "set_page_table_rows", "set_context_lens_rows", "set_kv_gap_rows",
    "set_last_token", "reset_slot", "reset_slots",
    "prefill", "prefill_batch", "prefill_chunk", "prefill_ring", "prefill_ring_segment",
    "commit_first_token",
    "decode", "ragged_mixed", "ragged_multi", "decode_loop", "decode_spec",
    "offload_pages", "restore_pages", "rebuild_device_state", "warmup",
)


@dataclass(frozen=True)
class _Shipped:
    """A tensor argument's place in a message: its index among the call's
    shipped tensors, shape and dtype."""

    index: int
    shape: tuple
    dtype: torch.dtype


def _strip(obj: Any, out: list) -> Any:
    """``obj`` with every tensor replaced by a ``_Shipped`` placeholder
    (the tensors appended to ``out``), through tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        return _Shipped(len(out) - 1, tuple(obj.shape), obj.dtype)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_strip(x, out) for x in obj)
    if isinstance(obj, dict):
        return {k: _strip(v, out) for k, v in obj.items()}
    return obj


def _fill(obj: Any, tensors: list) -> Any:
    if isinstance(obj, _Shipped):
        return tensors[obj.index]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fill(x, tensors) for x in obj)
    if isinstance(obj, dict):
        return {k: _fill(v, tensors) for k, v in obj.items()}
    return obj


def _shipped(obj: Any) -> list:
    if isinstance(obj, _Shipped):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [s for x in obj for s in _shipped(x)]
    if isinstance(obj, dict):
        return [s for v in obj.values() for s in _shipped(v)]
    return []


class RankChannel:
    """Rank 0's messages to every rank: a CPU gloo group of its own for the
    pickled calls, the mesh's ``"world"`` group for their tensors. Every rank
    of the world must construct it at the same point (it creates a process
    group over the world), or pass ``group``: a CPU gloo group over the
    mesh's ranks that every rank of the world made alike (a mesh over part of
    a world)."""

    def __init__(self, mesh: Any, timeout_s: float = DEFAULT_TIMEOUT_S, group: Any = None):
        import torch.distributed as dist

        self.group = group if group is not None else dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
        self.mesh_group = mesh.group("world")
        self.device = mesh.device
        self.rank = mesh.rank
        self.timeout_s = timeout_s

    def send(self, msg: tuple) -> None:
        import torch.distributed as dist

        tensors: list = []
        body = _strip(msg, tensors)
        dist.broadcast_object_list([body], src=0, group=self.group)
        for t in tensors:
            dist.broadcast(t.to(self.device).contiguous(), src=0, group=self.mesh_group)

    def recv(self) -> tuple:
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        body = box[0]
        tensors = []
        for s in _shipped(body):
            t = torch.empty(s.shape, dtype=s.dtype, device=self.device)
            dist.broadcast(t, src=0, group=self.mesh_group)
            tensors.append(t)
        return _fill(body, tensors)


class Leader:
    """Rank 0's side: makes ``engine`` rank 0's by wrapping its
    ``FORWARDED`` methods on the instance, so each call is sent before it
    runs, and sends a heartbeat when no call has gone out for
    ``timeout_s / 4``. ``watch`` (polled every ``WATCH_S``) returns why the
    group cannot go on, or None; once it names a reason (``failure``),
    every forwarded call raises ``RankDown``."""

    def __init__(self, engine: Any, channel: RankChannel, watch=None):
        self.engine = engine
        self.channel = channel
        self.watch = watch
        self.failure: str | None = None
        self._lock = threading.RLock()
        self._local = threading.local()
        self._last_send = time.monotonic()
        self._stopped = threading.Event()
        for name in FORWARDED:
            setattr(engine, name, self._forwarding(name, getattr(engine, name)))
        self._beat = threading.Thread(target=self._heartbeat, name="finchat-rank-heartbeat",
                                      daemon=True)
        self._beat.start()

    def _send(self, msg: tuple) -> None:
        self.channel.send(msg)
        self._last_send = time.monotonic()

    def _forwarding(self, name: str, fn):
        def call(*args, **kwargs):
            if self.failure is not None:
                raise RankDown(f"{name}: {self.failure}")
            with self._lock:
                if self.failure is not None:
                    raise RankDown(f"{name}: {self.failure}")
                if self._stopped.is_set():
                    raise RuntimeError(f"{name}: the rank group is closed")
                depth = getattr(self._local, "depth", 0)
                if depth == 0:
                    self._send(("call", name, args, kwargs))
                self._local.depth = depth + 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._local.depth = depth

        call.__name__ = name
        return call

    def _heartbeat(self) -> None:
        period = self.channel.timeout_s / 4
        while not self._stopped.wait(min(period / 4, WATCH_S)):
            down = self.watch() if self.watch is not None else None
            if down is not None:
                self.fail(down)
                return
            if time.monotonic() - self._last_send < period:
                continue
            if self._lock.acquire(blocking=False):
                try:
                    if not self._stopped.is_set():
                        self._send(("ping",))
                finally:
                    self._lock.release()

    def fail(self, reason: str) -> None:
        """Mark the group down: nothing more is sent (a dead rank's channel
        could only block), and every forwarded call raises ``RankDown``."""
        if self.failure is None:
            logger.error("tensor-parallel group down: %s", reason)
            self.failure = reason
        self._stopped.set()

    def stop(self) -> None:
        """Send the stop message (once) and restore the engine's methods."""
        with self._lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
            try:
                self._send(("stop",))
            finally:
                for name in FORWARDED:
                    self.engine.__dict__.pop(name, None)
        self._beat.join(timeout=5.0)


def follow(engine: Any, channel: RankChannel) -> int:
    """Run rank 0's calls on this rank's engine until the stop message (or
    the channel's error, when rank 0 is gone: it propagates). Returns the
    number of calls made."""
    n = 0
    while True:
        msg = channel.recv()
        if msg[0] == "stop":
            return n
        if msg[0] == "ping":
            continue
        _, name, args, kwargs = msg
        getattr(engine, name)(*args, **kwargs)
        n += 1


def rendezvous() -> str:
    """A fresh ``file://`` rendezvous every rank of one group names alike
    (a new temporary directory: concurrent groups never share one)."""
    return "file://" + str(Path(tempfile.mkdtemp(prefix="finchat-ranks-")) / "store")


def _follower_main(rank: int, world: int, init_method: str, backend: str, devices: list,
                   cfg: Any, timeout_s: float) -> None:
    """A spawned follower: join the group, build the mesh and the channel,
    load this rank's shard of the model and follow rank 0 until it stops."""
    import torch.distributed as dist

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.parallel.mesh import MeshSpec, build_mesh, initialize_distributed
    from finchat_tpu_torch.serve.app import _load_model_artifacts

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(world, rank, backend=backend, init_method=init_method,
                           timeout_s=timeout_s, device=device)
    try:
        mesh = build_mesh(MeshSpec.from_config(cfg.mesh), devices, backend)
        channel = RankChannel(mesh, timeout_s)
        config, params, _tok, _dev = _load_model_artifacts(cfg, device, mesh=mesh)
        engine = InferenceEngine(config, params, cfg.engine, quant=cfg.model.quant,
                                 quant_group=cfg.model.quant_group, mesh=mesh)
        del params
        n = follow(engine, channel)
        logger.info("rank %d: stopped after %d calls", rank, n)
    finally:
        dist.destroy_process_group()


def spawn_followers(cfg: Any, devices: list, backend: str, init_method: str,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Start ranks 1..len(devices)-1 as daemon processes (spawn context):
    each runs ``_follower_main``. Rank 0 joins the group after this."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(1, len(devices)):
        p = ctx.Process(target=_follower_main, name=f"finchat-rank-{rank}", daemon=True,
                        args=(rank, len(devices), init_method, backend,
                              [str(d) for d in devices], cfg, timeout_s))
        p.start()
        procs.append(p)
    return procs


class RankGroup:
    """Rank 0's handle on a served mesh: the leader and the follower
    processes. ``down`` says which follower has exited, if one has;
    ``close`` stops the followers, joins them (terminating one that does not
    exit within ``join_s``) and leaves the process group."""

    def __init__(self, leader: Leader | None, procs: list):
        self.leader = None
        self.procs = procs
        self.closed = False
        if leader is not None:
            self.attach(leader)

    def attach(self, leader: Leader) -> None:
        """Make ``leader`` this group's: it watches the followers."""
        self.leader = leader
        leader.watch = self.down

    def down(self) -> str | None:
        """Why the group cannot serve (a follower process has exited), or
        None while every follower lives."""
        for p in self.procs:
            if not p.is_alive():
                return f"rank process {p.name} exited with code {p.exitcode}"
        return None

    def close(self, join_s: float = 30.0) -> None:
        import torch.distributed as dist

        if self.closed:
            return
        self.closed = True
        try:
            if self.leader is not None:
                self.leader.stop()
        except Exception as e:  # a follower already gone: nothing to stop
            logger.error("rank group stop: %s", e)
        for p in self.procs:
            p.join(timeout=join_s)
            if p.is_alive():
                logger.error("rank process %s did not stop; terminating it", p.name)
                p.terminate()
                p.join(timeout=5.0)
        if dist.is_initialized():
            dist.destroy_process_group()

    @property
    def live(self) -> int:
        return sum(p.is_alive() for p in self.procs)
