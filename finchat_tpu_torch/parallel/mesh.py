"""The device mesh over ``torch.distributed`` ranks (the JAX package's
``parallel/mesh.py``, as SPMD processes).

Axis convention (scaling-book style), in the JAX package's order:
- ``data``   — batch/DP;
- ``pipe``   — pipeline stages;
- ``seq``    — sequence/context parallelism;
- ``expert`` — expert parallelism;
- ``model``  — tensor parallelism: attention heads and the MLP hidden dim
  sharded, two all-reduces a layer (the last, fastest-varying axis).

The JAX package runs one controller over many devices and lets GSPMD place
the collectives. PyTorch has no GSPMD: here every device is one process (a
rank) that holds its own shard and runs the collectives of its axis
explicitly. A rank's coordinates are its rank in row-major order over
``AXES`` (the last axis fastest, as ``jax.make_mesh`` lays out a flat device
list), and each axis of size > 1 has a process group of the ranks that
differ only along it. The ``model`` axis always has one once the mesh is
distributed, a one-rank group included: the tensor-parallel layer issues its
collectives on it whatever its size.

Two kinds of group serve the training half beside the axes' own:

- ``("expert", "model")``: the ranks that differ only along ``expert`` and
  ``model`` (the expert index outermost), over which an MoE layer's output
  sums (``models/llama.moe_mlp``);
- the pipe neighbours ``("pipe", s)``: stages ``s`` and ``s + 1`` of this
  rank's pipe line, over which the pipeline hops an activation forward and
  its gradient back (``parallel/pipeline.py``).

Sequence parallelism (serving's long-prompt prefill) adds:

- the seq neighbours ``("seq", s)``: seq ranks ``s`` and ``(s + 1) % n`` of
  this rank's seq line (one a coordinate of the other axes), the pair a ring
  hop moves a block over (``parallel/collectives.ring_shift``); with two seq
  ranks the one pair is the ``seq`` group itself;
- ``"world"``: every rank of the mesh, over which rank 0 ships a forwarded
  call's tensors (``parallel/ranks.RankChannel``): with ``seq > 1`` the
  ``model`` group no longer holds every rank.

A mesh may span a subset of the world's ranks (``ranks``): every rank of the
world still creates every group, in the same fixed order.

A mesh with no process group (``make_abstract_mesh``) carries only the
shape and a rank's coordinates: the sharding rules and the shape checks
read nothing else.
"""

from __future__ import annotations

import datetime
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from finchat_tpu_torch.utils.config import MeshConfig
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

AXES = ("data", "pipe", "seq", "expert", "model")

# how long a collective may wait for its peers before it raises: a rank that
# died or hangs surfaces as an error on the others, never as a hang
DEFAULT_TIMEOUT_S = 120.0


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1
    model: int = -1  # -1 = absorb all remaining devices

    @classmethod
    def from_config(cls, cfg: MeshConfig) -> "MeshSpec":
        return cls(data=cfg.data, pipe=cfg.pipe, seq=cfg.seq,
                   expert=cfg.expert, model=cfg.model)

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        sizes = [self.data, self.pipe, self.seq, self.expert, self.model]
        free = [i for i, s in enumerate(sizes) if s == -1]
        fixed = 1
        for s in sizes:
            if s != -1:
                fixed *= s
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if free:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[free[0]] = n_devices // fixed
        total = 1
        for s in sizes:
            total *= s
        if total != n_devices:
            raise ValueError(f"mesh {dict(zip(AXES, sizes))} needs {total} devices, "
                             f"have {n_devices}")
        return tuple(sizes)


def mesh_devices(spec: MeshSpec, device: str | torch.device) -> list[torch.device]:
    """The devices a mesh config runs on, one rank each. On the card a -1
    axis absorbs every visible CUDA device, and a fixed mesh takes the first
    of its product (more than there are raises, as ``resolve`` does). On
    the CPU a -1 axis absorbs 1, so the default config stays unsharded, and
    a fixed mesh asks for its product in CPU ranks."""
    device = torch.device(device)
    sizes = (spec.data, spec.pipe, spec.seq, spec.expert, spec.model)
    fixed = 1
    for s in sizes:
        if s != -1:
            fixed *= s
    if device.type == "cuda":
        count = torch.cuda.device_count()
        n = count if -1 in sizes else fixed
        if n > count:
            spec.resolve(count)  # raises: the mesh needs more devices than there are
        spec.resolve(n)
        return [torch.device("cuda", i) for i in range(n)]
    spec.resolve(fixed)
    return [device] * fixed


@dataclass
class Mesh:
    """One rank's view of the mesh: the axis sizes, this rank's coordinates,
    its device, and the process group of each axis it collects over
    (``groups``; empty for a shape-only mesh)."""

    sizes: tuple[int, ...]
    names: tuple[str, ...] = AXES
    rank: int = 0
    device: torch.device | None = None
    backend: str | None = None
    groups: dict[Any, Any] = field(default_factory=dict)
    world_ranks: tuple[int, ...] | None = None  # the world rank of each mesh rank

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.sizes))

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along each axis (row-major, the last axis
        fastest)."""
        out, r = {}, self.rank
        for name, s in reversed(list(zip(self.names, self.sizes))):
            out[name] = r % s
            r //= s
        return {name: out[name] for name in self.names}

    def peer(self, axis: str, index: int) -> int:
        """The world rank of the rank at ``index`` along ``axis`` with this
        rank's other coordinates (a collective's ``src``)."""
        i = self.names.index(axis)
        stride = 1
        for s in self.sizes[i + 1:]:
            stride *= s
        local = self.rank + (index - self.coords[axis]) * stride
        return local if self.world_ranks is None else self.world_ranks[local]

    def group(self, axis):
        """The process group of ``axis`` (None on a shape-only mesh, or for
        an axis of size 1 other than ``model``); ``("expert", "model")``
        names the MoE output's group, ``("pipe", s)`` the pipe neighbours
        ``s`` and ``s + 1`` of this rank's line and ``("seq", s)`` the seq
        neighbours ``s`` and ``(s + 1) % n`` (each held only by those two),
        ``"world"`` every rank of the mesh."""
        return self.groups.get(axis)


def make_abstract_mesh(sizes: tuple, names: tuple = AXES, rank: int = 0) -> Mesh:
    """A shape-only mesh with no process group (the JAX package's
    ``AbstractMesh``), at ``rank``'s coordinates: the shape checks and the
    per-rank sharding rules build it with no process and no device."""
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} sizes for {len(names)} axis names")
    return Mesh(tuple(int(s) for s in sizes), tuple(names), rank=rank)


def _axis_rank_sets(sizes: tuple[int, ...], *axes: int) -> list[list[int]]:
    """The rank sets that differ only along ``axes``, in a fixed order
    (every rank must create every group, in the same order); within a set
    the ranks run row-major over ``axes``, the first outermost."""
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    total = strides[0] * sizes[0]
    offsets = [0]
    for a in axes:
        offsets = [o + i * strides[a] for o in offsets for i in range(sizes[a])]
    seen, out = set(), []
    for r in range(total):
        base = r - sum(((r // strides[a]) % sizes[a]) * strides[a] for a in axes)
        if base in seen:
            continue
        seen.add(base)
        out.append([base + o for o in offsets])
    return out


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(world_size: int = 1, rank: int = 0, *, backend: str = "gloo",
                           init_method: str | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S,
                           device: torch.device | None = None) -> None:
    """``torch.distributed.init_process_group`` with an explicit timeout.
    ``init_method`` is the rendezvous every rank names alike (a ``file://``
    path in a fresh temporary directory, or a ``tcp://`` address on a port
    the OS picked); a one-rank world without one rendezvous through a file
    of its own. ``device`` binds an NCCL group to this rank's card."""
    import torch.distributed as dist

    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs an init_method every rank "
                             "names alike")
        init_method = "file://" + str(Path(tempfile.mkdtemp(prefix="finchat-mesh-")) / "store")
    kwargs: dict[str, Any] = {}
    if backend == "nccl" and device is not None:
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    logger.info("distributed initialized: rank %d of %d (%s)", rank, world_size, backend)


def build_mesh(spec: MeshSpec | None = None, devices: list | None = None,
               backend: str | None = None, ranks: list[int] | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh | None:
    """This rank's mesh: ``spec`` resolved over ``devices`` (one rank a
    device; a device may repeat, as two gloo ranks on one card do), this
    rank's device and coordinates, and the process group of every axis of
    size > 1 and of ``model``, of ``("expert", "model")``, of each pipe and
    seq neighbour pair this rank is in, and of the whole mesh (``"world"``). The process group must be initialized
    first (``initialize_distributed``) with one rank a device, except for a
    single device, whose one-rank group is made here. The backend defaults
    to ``nccl`` for CUDA devices and ``gloo`` for the CPU.

    ``ranks``: the world ranks the mesh spans, in mesh order (default: the
    whole world). Every rank of the world calls ``build_mesh`` alike (a
    group is made by all of them); a rank outside ``ranks`` gets None.
    ``timeout_s`` bounds every collective of a group made here (a new group
    does not take the world's)."""
    import torch.distributed as dist

    spec = spec or MeshSpec()
    devices = [torch.device(d) for d in (devices if devices is not None else ["cpu"])]
    sizes = spec.resolve(len(devices))
    backend = backend or default_backend(devices[0])
    if not dist.is_initialized():
        if len(devices) != 1:
            raise RuntimeError(f"build_mesh over {len(devices)} devices: call "
                               "initialize_distributed on every rank first")
        initialize_distributed(1, 0, backend=backend, device=devices[0])
    world, me = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if len(ranks) != len(devices):
        raise ValueError(f"the mesh spans {len(ranks)} ranks and {len(devices)} devices")
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of a world of {world}")
    rank = ranks.index(me) if me in ranks else None
    mesh = None if rank is None else Mesh(sizes, AXES, rank=rank, device=devices[rank],
                                          backend=backend, world_ranks=tuple(ranks))

    def make(key, local_sets: list[list[int]]) -> None:
        for local in local_sets:
            members = [ranks[i] for i in local]
            group = dist.group.WORLD if len(members) == world else dist.new_group(
                members, timeout=datetime.timedelta(seconds=timeout_s))
            if mesh is not None and rank in local:
                mesh.groups[key] = group

    axis = {name: i for i, name in enumerate(AXES)}
    for i, name in enumerate(AXES):
        if sizes[i] == 1 and name != "model":
            continue
        make(name, _axis_rank_sets(sizes, i))
    if sizes[axis["expert"]] > 1:
        make(("expert", "model"), _axis_rank_sets(sizes, axis["expert"], axis["model"]))
    elif mesh is not None:
        mesh.groups[("expert", "model")] = mesh.groups["model"]
    n_pipe = sizes[axis["pipe"]]
    for s in range(n_pipe - 1):
        if n_pipe == 2:  # the one pair is the pipe line itself
            if mesh is not None:
                mesh.groups[("pipe", 0)] = mesh.groups["pipe"]
            break
        make(("pipe", s), [line[s:s + 2] for line in _axis_rank_sets(sizes, axis["pipe"])])
    n_seq = sizes[axis["seq"]]
    if n_seq == 2:  # the one pair is the seq line itself
        if mesh is not None:
            mesh.groups[("seq", 0)] = mesh.groups[("seq", 1)] = mesh.groups["seq"]
    elif n_seq > 2:
        for s in range(n_seq):
            make(("seq", s), [[line[s], line[(s + 1) % n_seq]]
                              for line in _axis_rank_sets(sizes, axis["seq"])])
    make("world", [list(range(len(ranks)))])
    if mesh is not None:
        logger.info("mesh: %s, rank %d (world rank %d) on %s (%s)", mesh.shape, rank, me,
                    mesh.device, backend)
    return mesh
