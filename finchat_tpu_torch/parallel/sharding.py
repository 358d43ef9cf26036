"""Sharding rules: the logical param/state layout to each rank's slice (the
JAX package's ``parallel/sharding.py``).

The JAX package annotates its weights with ``NamedSharding``s and lets
GSPMD insert the collectives. The port keeps the same spec table, as tuples
of axis names (``None`` = replicated along that dim), and cuts each leaf
down to THIS rank's slice; the layer issues the collectives itself
(``ops/tp_overlap.row_parallel_dense``, ``models/llama.lm_head``):

- attention q/k/v column-parallel over heads (``model``), the output
  projection row-parallel: one all-reduce;
- MLP gate/up column-parallel, down row-parallel: one all-reduce;
- the embedding and the norms replicated, ``lm_head`` vocab-sharded;
- KV-cache pages sharded over KV heads on ``model`` (matching the k/v
  projections, so cache writes stay local). The KV layout of a rank is
  decided here once (``kv_local`` and its inverse ``kv_full``): the TP
  engine's pool, its session records and ``shard_decode_state`` all take
  it from these two.

A spec axis whose mesh extent does not divide the dim replicates with a
warning, and raises for a tensor above 256 MiB (``_fit_sharding``).

For training over a mesh the MoE leaves split by the same table:
``moe_{gate,up}`` ``[L, E, D, F]`` over ``expert`` on E and ``model`` on F,
``moe_down`` ``[L, E, F, D]`` likewise, the router replicated
(``models/llama.moe_mlp`` sums the experts' output over the ``("expert",
"model")`` group); ``tp_shard`` is a rank's ``TPShard`` of a distributed
mesh, and ``shard_batch`` its slice of the batch over ``data``.

One deliberate difference from the JAX package: a row-parallel
``Q4Tensor`` (``attn_o``, ``mlp_down``) takes ITS OWN groups' scale rows,
``[G / tp, N]``, so its K shard is a whole int4 weight that the fused
dequant matmul reads as it is. The JAX package keeps every group on every
device (its ``shard_params`` replicates the group axis) and lets GSPMD sort
the contraction out. A rank whose groups do not divide is refused by name. And the int8 KV
scale planes ``[L, P, scale_rows(Hkv), PS]``: a rank holds its own heads'
rows in a block padded to ``scale_rows(Hkv / tp)`` (the row count the
kernels read), where the JAX package splits the padded block itself, and
only when ``Hkv % 8 == 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from finchat_tpu_torch.engine.kv_cache import scale_rows
from finchat_tpu_torch.models.quant import Q4Tensor, QTensor
from finchat_tpu_torch.parallel.mesh import Mesh
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

Spec = tuple  # one entry a dim: None, an axis name, or a tuple of axis names


def llama_param_shardings(mesh: Mesh) -> dict[str, Any]:
    """The spec tree of ``models/llama.init_params``'s layout. The leading
    axis of every ``layers`` leaf is the stacked layer axis, never sharded.
    The table is the JAX package's; ``mesh`` is taken for its signature."""
    del mesh
    return {
        "embed": (None, None),
        "layers": {
            "attn_q": (None, None, "model"),  # [L, D, H*hd] column-parallel
            "attn_k": (None, None, "model"),
            "attn_v": (None, None, "model"),
            "attn_o": (None, "model", None),  # [L, H*hd, D] row-parallel
            "mlp_gate": (None, None, "model"),
            "mlp_up": (None, None, "model"),
            "mlp_down": (None, "model", None),
            "router": (None, None, None),
            "moe_gate": (None, "expert", None, "model"),  # [L, E, D, F]
            "moe_up": (None, "expert", None, "model"),
            "moe_down": (None, "expert", "model", None),  # [L, E, F, D]
            "ln_attn": (None, None),
            "ln_mlp": (None, None),
        },
        "norm": (None,),
        "lm_head": (None, "model"),  # vocab-sharded logits
    }


def check_kv_heads(n_kv_heads: int, tp: int) -> None:
    """Refuse by name a ``model`` axis that does not divide the KV heads: a
    rank holds whole heads (the JAX package replicates the pages then; that
    layout is not ported)."""
    if n_kv_heads % tp:
        raise NotImplementedError(
            f"mesh: model={tp} does not divide n_kv_heads={n_kv_heads}; a rank must hold whole "
            "heads (the replicated-KV layout is not ported)")


def decode_state_shardings(mesh: Mesh, n_kv_heads: int) -> dict[str, Spec]:
    """Specs of the TP engine's ``DecodeState`` fields: the fused KV-head dim
    of the pages on ``model`` (whole heads a rank, else refused by name),
    the int8 scale planes' head rows on ``model`` (each rank's own heads'
    rows, its block padded to ``scale_rows(Hkv / tp)``: ``kv_local``), the
    rest replicated."""
    check_kv_heads(n_kv_heads, mesh.shape.get("model", 1))
    kv_spec = (None, None, None, "model")
    scale_spec = (None, None, "model", None)
    return {
        "k_pages": kv_spec,
        "v_pages": kv_spec,
        "k_scales": scale_spec,
        "v_scales": scale_spec,
        "page_table": (None, None),
        "context_lens": (None,),
        "last_tokens": (None,),
        "kv_gaps": (None,),
    }


# Tensors above this size refuse to silently replicate when their sharded
# dim does not divide the mesh axis: at that scale replication is a memory
# blow-up on a real checkpoint and the config error must fail fast. Small
# (debug-model) tensors replicate with a warning so tiny presets run on any
# mesh.
_REPLICATE_LIMIT_BYTES = 256 * 1024 * 1024


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _extent(mesh: Mesh, entry) -> int:
    n = 1
    for a in _axes(entry):
        n *= mesh.shape[a]
    return n


def _fit_sharding(spec: Spec, shape: tuple[int, ...], nbytes: int, mesh: Mesh) -> Spec:
    """Drop (replicate) any spec axis whose mesh extent does not divide the
    dim; raise instead when the tensor is too large to replicate safely.
    Production-sized configs divide evenly and are untouched."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    fitted = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            fitted.append(None)
            continue
        extent = _extent(mesh, entry)
        if dim % extent:
            if nbytes > _REPLICATE_LIMIT_BYTES:
                raise ValueError(
                    f"dim of size {dim} (tensor shape {tuple(shape)}, {nbytes} bytes) is not "
                    f"divisible by mesh axes {entry!r} = {extent}; refusing to replicate a "
                    "tensor this large — fix the mesh/model config")
            if dim > 1:
                logger.warning("replicating dim of size %d (not divisible by mesh axes %r = %d)",
                               dim, entry, extent)
            fitted.append(None)
        else:
            fitted.append(entry)
    return tuple(fitted)


def _shard_index(mesh: Mesh, entry) -> int:
    """This rank's block along a dim sharded over ``entry``'s axes (several
    axes combine row-major, the first outermost)."""
    coords, idx = mesh.coords, 0
    for a in _axes(entry):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def _local(x: torch.Tensor, spec: Spec, mesh: Mesh, device: torch.device | None) -> torch.Tensor:
    """This rank's slice of ``x`` under a fitted ``spec``: a contiguous tensor
    of its own on ``device`` (so the full tensor can be freed); a tensor with
    no dim cut (replicated, or over a one-rank axis) is moved, not copied,
    when it already lies there."""
    view = x
    for d, entry in enumerate(spec):
        if entry is None or _extent(mesh, entry) == 1:
            continue
        size = x.shape[d] // _extent(mesh, entry)
        view = view.narrow(d, _shard_index(mesh, entry) * size, size)
    device = device if device is not None else x.device
    if view is x:
        return x.to(device)
    return torch.empty(view.shape, dtype=view.dtype, device=device).copy_(view)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def shard_leaf(x: Any, spec: Spec, mesh: Mesh, device: torch.device | None = None,
               name: str = "") -> Any:
    """One leaf (a tensor, ``QTensor`` or ``Q4Tensor``) cut to this rank's
    slice. A ``QTensor``'s per-column scale follows the output axis; a
    ``Q4Tensor``'s per-group scale follows the output axis and, for a
    row-parallel leaf, the contraction axis too (its own groups)."""
    if isinstance(x, QTensor):
        qspec = _fit_sharding(spec, tuple(x.q.shape), _nbytes(x.q), mesh)
        sspec = qspec[:-2] + (qspec[-1],)
        return QTensor(q=_local(x.q, qspec, mesh, device), scale=_local(x.scale, sspec, mesh, device))
    if isinstance(x, Q4Tensor):
        qspec = _fit_sharding(spec, tuple(x.q.shape), _nbytes(x.q), mesh)
        G = x.scale.shape[-2]
        if qspec[-2] is not None and G % _extent(mesh, qspec[-2]):
            raise ValueError(
                f"{name or 'an int4 leaf'}: its {G} scale groups do not divide over mesh axes "
                f"{qspec[-2]!r} = {_extent(mesh, qspec[-2])}; a row-parallel int4 shard must "
                "hold whole groups (pick quant_group so that K / tp is a multiple of it)")
        sspec = qspec[:-2] + (qspec[-2], qspec[-1])
        return Q4Tensor(q=_local(x.q, qspec, mesh, device),
                        scale=_local(x.scale, sspec, mesh, device))
    return _local(x, _fit_sharding(spec, tuple(x.shape), _nbytes(x), mesh), mesh, device)


def leaf_sharder(mesh: Mesh, device: torch.device | str | None = None,
                 specs: dict[str, Any] | None = None):
    """A ``leaf_transform`` for ``models/llama.init_params``,
    ``models/quant.init_quantized_params`` and
    ``checkpoints/hf_loader.load_llama_params``: each leaf, named as the
    param tree names it, cut to this rank's slice (``shard_leaf``) as soon
    as it is made or loaded, so a rank never holds more than its shard and
    one whole leaf (with its quantized copy while it is quantized).
    ``specs``: the spec tree (default ``llama_param_shardings``; the
    pipeline's is ``parallel/pipeline.pipeline_shardings``)."""
    specs = specs if specs is not None else llama_param_shardings(mesh)
    by_name = {**{k: v for k, v in specs.items() if k != "layers"}, **specs["layers"]}
    device = torch.device(device) if device is not None else mesh.device

    def transform(name: str, leaf: Any) -> Any:
        spec = by_name[name]
        ndim = len((leaf.q if isinstance(leaf, (QTensor, Q4Tensor)) else leaf).shape)
        if name.startswith("moe_") and ndim == 3:  # one layer's [E, ...] of an expert leaf
            if spec and spec[0] is not None:
                raise NotImplementedError(
                    f"{name}: a layer's experts are made one layer at a time and cannot be cut "
                    f"over {spec[0]!r} as they are made; cut the whole tree instead")
            spec = spec[1:]
        return shard_leaf(leaf, spec, mesh, device, name=name)

    return transform


def shard_params(params: dict[str, Any], shardings: dict[str, Any], mesh: Mesh,
                 device: torch.device | str | None = None) -> dict[str, Any]:
    """This rank's slice of a param tree (host or one device), each leaf a
    contiguous tensor of its own on ``device`` (default: the mesh's, else
    where it lies). Spec entries with no matching param (``lm_head`` under
    tied embeddings, MoE specs on a dense model) are pruned at every dict
    level; non-dividing dims replicate (``_fit_sharding``)."""
    if device is None:
        device = mesh.device
    device = torch.device(device) if device is not None else None

    def place(tree, spec, path):
        if isinstance(tree, dict):
            return {k: place(v, spec[k], f"{path}/{k}" if path else k) for k, v in tree.items()}
        return shard_leaf(tree, spec, mesh, device, name=path)

    return place(params, shardings, "")


def kv_local(k_pages: torch.Tensor, v_pages: torch.Tensor, k_scales, v_scales,
             n_kv_heads: int, tp: int, rank: int) -> tuple:
    """This rank's KV of the one-device layout (a pool, or a session record:
    pages ``[L, P, PS, Hkv * hd]``, scale planes ``[L, P, scale_rows(Hkv),
    PS]`` or None): its heads' slice of the fused dim, and its heads' scale
    rows at the top of a zero block of ``scale_rows(Hkv / tp)`` rows. Views
    of the pages where they can be (the caller copies)."""
    check_kv_heads(n_kv_heads, tp)
    hl = n_kv_heads // tp
    row = k_pages.shape[-1] // tp

    def scales(sc):
        if sc is None:
            return None
        out = sc.new_zeros(tuple(sc.shape[:2]) + (scale_rows(hl),) + tuple(sc.shape[3:]))
        out[:, :, :hl] = sc[:, :, rank * hl:(rank + 1) * hl]
        return out

    return (k_pages[..., rank * row:(rank + 1) * row], v_pages[..., rank * row:(rank + 1) * row],
            scales(k_scales), scales(v_scales))


def kv_full(parts: list, n_kv_heads: int) -> tuple:
    """``kv_local``'s inverse: every rank's ``(k, v, k_scales, v_scales)`` in
    rank order made into one of the one-device layout (the pages
    concatenated in head order along the fused dim, each rank's live scale
    rows at its heads' rows of a zero ``scale_rows(Hkv)`` block)."""
    tp = len(parts)
    hl = n_kv_heads // tp
    k = torch.cat([p[0] for p in parts], dim=-1)
    v = torch.cat([p[1] for p in parts], dim=-1)

    def scales(i):
        if parts[0][i] is None:
            return None
        first = parts[0][i]
        full = first.new_zeros(tuple(first.shape[:2]) + (scale_rows(n_kv_heads),)
                               + tuple(first.shape[3:]))
        full[:, :, :n_kv_heads] = torch.cat([p[i][:, :, :hl] for p in parts], dim=2)
        return full

    return k, v, scales(2), scales(3)


def shard_decode_state(state, mesh: Mesh, n_kv_heads: int):
    """This rank's slice of a one-device engine ``DecodeState``: the KV of
    ``kv_local`` (the TP engine's own pool layout; the float cache's absent
    scale planes stay ``None``), contiguous; the rest replicated (the
    generator is kept)."""
    tp, rank = mesh.shape.get("model", 1), mesh.coords.get("model", 0)
    k, v, ks, vs = kv_local(state.k_pages, state.v_pages, state.k_scales, state.v_scales,
                            n_kv_heads, tp, rank)
    return dataclasses.replace(state, k_pages=k.contiguous(), v_pages=v.contiguous(),
                               k_scales=ks, v_scales=vs)


def tp_shard(mesh: Mesh, *, overlap: bool = False, n_chunks: int = 4):
    """This rank's ``TPShard`` (``LlamaConfig.tp``) of a distributed mesh:
    the ``model`` group and coordinate, and for MoE layers the ``("expert",
    "model")`` group with this rank's place on ``expert``."""
    from finchat_tpu_torch.ops.tp_overlap import TPShard

    if mesh.group("model") is None:
        raise ValueError("a sharded model needs a distributed mesh (parallel/mesh.build_mesh), "
                         "not a shape-only one")
    return TPShard(group=mesh.group("model"), size=mesh.shape["model"],
                   rank=mesh.coords["model"], overlap=overlap, n_chunks=n_chunks,
                   expert_group=mesh.group(("expert", "model")), ep_size=mesh.shape["expert"],
                   ep_rank=mesh.coords["expert"])


def shard_batch(tokens: torch.Tensor, mesh: Mesh, seq_sharded: bool = False) -> torch.Tensor:
    """This rank's slice of a batch ``[B, ...]`` over ``data`` (contiguous,
    on the mesh's device): the JAX package's ``shard_batch``. A batch the
    data axis does not divide is refused; ``seq_sharded`` (the sequence
    axis over ``seq``) is not ported."""
    if seq_sharded:
        raise NotImplementedError("shard_batch: a seq-sharded batch (sequence parallelism, ring "
                                  "or Ulysses attention) is not ported yet")
    dp, r = mesh.shape["data"], mesh.coords["data"]
    B = tokens.shape[0]
    if B % dp:
        raise ValueError(f"shard_batch: batch {B} does not split over data={dp}")
    b = B // dp
    out = tokens[r * b:(r + 1) * b]
    return out.to(mesh.device).contiguous() if mesh.device is not None else out.contiguous()
