"""Pipeline parallelism over the ``pipe`` mesh axis (the JAX package's
``parallel/pipeline.py``), as SPMD ranks over ``torch.distributed``.

The JAX package scans a GPipe fill/drain schedule of ``n_micro + P - 1``
ticks inside one all-manual ``shard_map`` and lets autodiff transpose it.
Here each stage is a rank (with its in-stage data and model peers), and the
schedule is the PyTorch idiom of it:

- forward: for each microbatch in order, stage 0 embeds it and every other
  stage receives the activation from the stage before; the stage runs its
  contiguous block of ``L / P`` layers (per-layer recompute with ``remat``)
  and hands the result on. Stage ``s`` holds microbatch ``m`` with ``m``'s
  own positions (the reference's ``t - s`` at tick ``t``). The last stage
  applies the final norm and the head and, in training, the microbatch's
  mean cross-entropy;
- backward, microbatches in reverse: the last stage backpropagates its
  microbatch loss over ``n_micro`` (the loss is the mean of the microbatch
  means, the reference's mean over the batch), every other stage receives
  its output's gradient, calls ``torch.autograd.backward`` and hands its
  input's gradient back.

A hop is a ``broadcast`` over the two neighbours' group (``("pipe", s)`` of
``parallel/mesh.build_mesh``), which gloo takes for CPU and CUDA tensors
alike. Every stage issues its hops and its in-stage collectives in one
fixed order, so no group waits on another.

In-stage TP is Megatron-style over ``model`` (``_stage_tp``,
``_pipeline_layer_specs``: the reference's rule, dense models whose heads,
KV heads and hidden dim divide; MoE stages and indivisible heads run
replicated over ``model`` with a warning), with the layer's differentiable
collectives and its ``tp_overlap`` / ``tp_chunks`` knob. In-stage DP slices
the batch over ``data`` when ``B % (data x n_micro) == 0`` (else it warns
and replicates). The embedding, the final norm and the head are replicated
on every rank, as the reference places them; their gradients are summed
over ``pipe`` (a stage that did not use one adds zeros), and every
gradient is then averaged over ``data`` when DP is on.

``pipeline_forward`` returns the logits on every rank (the last stage
broadcasts them over ``pipe``, and the data slices are gathered), as the
JAX output is replicated. Sequence parallelism inside a stage (``seq > 1``,
the reference's ring body) is not ported and is refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from finchat_tpu_torch.models.llama import (
    LlamaConfig,
    _layer,
    lm_head,
    make_causal_attention,
    rms_norm,
)
from finchat_tpu_torch.parallel.collectives import mean_grads, mean_over
from finchat_tpu_torch.parallel.mesh import Mesh
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Megatron split of a stage's layer leaves (the leading dim is the stacked
# layer axis, sharded over pipe): column-parallel out dims, row-parallel in
# dims; everything else (norms, MoE leaves) replicated in-stage
_TP_COL = ("attn_q", "attn_k", "attn_v", "mlp_gate", "mlp_up")
_TP_ROW = ("attn_o", "mlp_down")
# the leaves outside the layer stack: replicated on every rank, their
# gradients summed over pipe
_REPLICATED = ("embed", "norm", "lm_head")


def _stage_tp(config: LlamaConfig, mesh: Mesh) -> int:
    """In-stage TP degree: the mesh's ``model`` extent when the head /
    hidden dims divide it (and the model is dense); 1 (replicated, with a
    warning) otherwise."""
    tp = mesh.shape.get("model", 1)
    if tp == 1:
        return 1
    ok = (
        not config.n_experts
        and config.n_heads % tp == 0
        and config.n_kv_heads % tp == 0
        and config.hidden_dim % tp == 0
    )
    if not ok:
        logger.warning(
            "pipeline in-stage TP disabled: model axis %d does not divide "
            "heads/kv/hidden (%d/%d/%d) or the model is MoE; stages run "
            "replicated over model",
            tp, config.n_heads, config.n_kv_heads, config.hidden_dim,
        )
        return 1
    return tp


def _pipeline_layer_specs(layers: dict[str, Any], tp: int) -> dict[str, tuple]:
    """Each layer leaf's spec: the stacked axis over ``pipe``, and with
    in-stage TP the Megatron dim over ``model``."""

    def spec(name: str) -> tuple:
        if tp > 1 and name in _TP_COL:
            return ("pipe", None, "model")
        if tp > 1 and name in _TP_ROW:
            return ("pipe", "model", None)
        return ("pipe",)

    return {name: spec(name) for name in layers}


def _check_stages(config: LlamaConfig, mesh: Mesh) -> None:
    P = mesh.shape["pipe"]
    if config.n_layers % P:
        raise ValueError(f"pipeline: n_layers={config.n_layers} does not split into pipe={P} "
                         "stages of whole layers")
    if mesh.shape["seq"] > 1:
        raise NotImplementedError(f"pipeline: seq={mesh.shape['seq']}: sequence parallelism "
                                  "inside a stage (the ring body) is not ported yet")


def _shardings(names: list[str], layers: list[str], tp: int) -> dict[str, Any]:
    out: dict[str, Any] = {name: () for name in names if name != "layers"}
    out["layers"] = _pipeline_layer_specs(dict.fromkeys(layers), tp)
    return out


def pipeline_shardings(config: LlamaConfig, mesh: Mesh) -> dict[str, Any]:
    """The spec tree of ``shard_params_for_pipeline`` for ``config``'s
    layout (``models/llama.init_params``), for a rank that cuts each leaf as
    it is made (``parallel/sharding.leaf_sharder(mesh, device, specs)``)."""
    _check_stages(config, mesh)
    layers = ["attn_q", "attn_k", "attn_v", "attn_o", "ln_attn", "ln_mlp"]
    layers += (["router", "moe_gate", "moe_up", "moe_down"] if config.n_experts
               else ["mlp_gate", "mlp_up", "mlp_down"])
    return _shardings(list(_REPLICATED), layers, _stage_tp(config, mesh))


def shard_params_for_pipeline(params: dict[str, Any], mesh: Mesh,
                              config: LlamaConfig | None = None,
                              device: torch.device | str | None = None) -> dict[str, Any]:
    """This rank's slice of a param tree: its stage's contiguous ``L / P``
    layers with — when ``config`` is given and divisible — their Megatron
    slices over ``model``; the embedding, the final norm and the head
    replicated (each leaf a contiguous tensor of its own, as
    ``parallel/sharding.shard_params`` makes it)."""
    from finchat_tpu_torch.parallel.sharding import shard_params

    tp = 1
    if config is not None:
        _check_stages(config, mesh)
        tp = _stage_tp(config, mesh)
    return shard_params(params, _shardings(list(params), list(params["layers"]), tp), mesh,
                        device)


def _stage_config(config: LlamaConfig, mesh: Mesh, tp_overlap: bool,
                  tp_chunks: int) -> LlamaConfig:
    """``config`` with the stage's in-stage TP shard, or none."""
    from finchat_tpu_torch.parallel.sharding import tp_shard

    if _stage_tp(config, mesh) == 1:
        return dataclasses.replace(config, tp=None)
    return dataclasses.replace(config, tp=tp_shard(mesh, overlap=tp_overlap, n_chunks=tp_chunks))


def _stage_block(x: torch.Tensor, layers: dict[str, Any], positions: torch.Tensor, *,
                 config: LlamaConfig, attention, remat: bool) -> torch.Tensor:
    """This stage's layers over one microbatch (``layers`` stacked leaves
    or per-layer lists), each recomputed in the backward with ``remat``."""
    n = len(next(iter(layers.values())))
    for i in range(n):
        lp = {name: leaf[i] for name, leaf in layers.items()}
        kw = dict(positions=positions, config=config, attention=attention)
        if remat:
            x, _ = torch.utils.checkpoint.checkpoint(_layer, x, lp, None, i,
                                                     use_reentrant=False, **kw)
        else:
            x, _ = _layer(x, lp, None, i, **kw)
    return x


def _data_slice(tokens: torch.Tensor, mesh: Mesh, n_micro: int) -> tuple[int, slice]:
    """The in-stage DP degree and this rank's rows of the batch (all of them
    when DP is off)."""
    dp = mesh.shape.get("data", 1)
    B = tokens.shape[0]
    if B % (dp * n_micro):
        logger.warning(
            "pipeline in-stage DP disabled: batch %d does not split into "
            "data=%d x n_micro=%d; the data axis runs replicated",
            B, dp, n_micro,
        )
        dp = 1
    if B % (dp * n_micro):
        raise ValueError(f"pipeline: batch {B} does not split into n_micro={n_micro} "
                         "microbatches")
    b = B // dp
    r = mesh.coords["data"] if dp > 1 else 0
    return dp, slice(r * b, (r + 1) * b)


def _hop(t: torch.Tensor, mesh: Mesh, lower: int, src_stage: int) -> torch.Tensor:
    """``t`` from stage ``src_stage`` to the other of stages ``lower`` and
    ``lower + 1`` (a broadcast over their pair group; in place on the
    receiver)."""
    import torch.distributed as dist

    dist.broadcast(t, src=mesh.peer("pipe", src_stage), group=mesh.group(("pipe", lower)))
    return t


def _schedule(params: dict[str, Any], tokens: torch.Tensor, positions: torch.Tensor, *,
              config: LlamaConfig, mesh: Mesh, n_micro: int, remat: bool, tp_overlap: bool,
              tp_chunks: int, train: bool):
    """One pass of the fill/drain schedule over this rank's data slice.
    Training: forward and backward with every leaf's gradient in its
    ``.grad`` (``params`` the per-layer views of ``layer_views``); its
    result is the slice's loss on the last stage, else None. Otherwise: the
    slice's fp32 logits on the last stage, else None. Returns ``(result,
    in-stage DP degree, this rank's rows of the batch)``."""
    _check_stages(config, mesh)
    P, s = mesh.shape["pipe"], mesh.coords["pipe"]
    last = s == P - 1
    cfg = _stage_config(config, mesh, tp_overlap, tp_chunks)
    attention = make_causal_attention()
    dp, rows = _data_slice(tokens, mesh, n_micro)
    tokens, positions = tokens[rows], positions[rows]
    mb = tokens.shape[0] // n_micro
    S, D = tokens.shape[1], config.dim
    inputs, outputs, results = [], [], []
    for m in range(n_micro):
        tok, pos = tokens[m * mb:(m + 1) * mb], positions[m * mb:(m + 1) * mb]
        if s == 0:
            x = params["embed"][tok.long()]
        else:
            x = _hop(torch.empty((mb, S, D), dtype=config.dtype, device=tokens.device),
                     mesh, s - 1, s - 1)
            if train:
                x.requires_grad_(True)
        y = _stage_block(x, params["layers"], pos, config=cfg, attention=attention,
                         remat=remat)
        inputs.append(x)
        outputs.append(y)
        if not last:
            _hop(y.detach().clone(), mesh, s, s)
            continue
        logits = lm_head(params, rms_norm(y, params["norm"], config.norm_eps), config=cfg)
        if train:
            results.append(F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                           tok[:, 1:].reshape(-1).long()))
        else:
            results.append(logits)
    if not train:
        return (torch.cat(results) if last else None), dp, rows
    for m in reversed(range(n_micro)):
        if last:
            (results[m] / n_micro).backward()
        else:
            g = _hop(torch.empty_like(outputs[m]), mesh, s, s + 1)
            torch.autograd.backward(outputs[m], g)
        if s > 0:
            _hop(inputs[m].grad, mesh, s - 1, s)
    if not last:
        return None, dp, rows
    return torch.stack([r.detach() for r in results]).sum() / n_micro, dp, rows


def pipeline_forward(params: dict[str, Any], tokens: torch.Tensor, positions: torch.Tensor, *,
                     config: LlamaConfig, mesh: Mesh, n_micro: int, remat: bool = True,
                     tp_overlap: bool = False, tp_chunks: int = 4) -> torch.Tensor:
    """Full forward through the stage pipeline; the fp32 logits ``[B, S,
    vocab]`` on every rank. ``params`` this rank's slice
    (``shard_params_for_pipeline``), ``tokens`` and ``positions`` the
    whole batch. Requires ``n_layers % pipe == 0`` and ``B % n_micro ==
    0``. Forward only (no autograd; ``remat`` is kept for the JAX
    signature): the train step runs the same schedule with its backward.
    ``tp_overlap`` switches the in-stage row-parallel outputs to the chunked
    schedule (byte-identical)."""
    import torch.distributed as dist

    with torch.no_grad():
        out, dp, rows = _schedule(params, tokens, positions, config=config, mesh=mesh,
                                  n_micro=n_micro, remat=remat, tp_overlap=tp_overlap,
                                  tp_chunks=tp_chunks, train=False)
        P = mesh.shape["pipe"]
        if out is None:
            out = torch.empty((rows.stop - rows.start, tokens.shape[1], config.vocab_size),
                              dtype=torch.float32, device=tokens.device)
        if P > 1:
            dist.broadcast(out, src=mesh.peer("pipe", P - 1), group=mesh.group("pipe"))
        if dp == 1:
            return out
        full = out.new_zeros((tokens.shape[0],) + tuple(out.shape[1:]))
        full[rows] = out
        dist.all_reduce(full, group=mesh.group("data"))  # x + 0 = x: exact
        return full


def _sum_over_pipe(params: dict[str, Any], mesh: Mesh) -> None:
    """The replicated leaves' gradients summed over ``pipe`` (zeros where a
    stage did not use the leaf)."""
    import torch.distributed as dist

    if mesh.shape["pipe"] == 1:
        return
    for name in _REPLICATED:
        leaf = params.get(name)
        if leaf is None:
            continue
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        dist.all_reduce(leaf.grad, group=mesh.group("pipe"))


def make_pipeline_train_step(config: LlamaConfig, optimizer, mesh: Mesh, *, n_micro: int,
                             remat: bool = True, tp_overlap: bool = False, tp_chunks: int = 4):
    """Build ``train_step(state, tokens) -> (state, loss)`` running the
    forward and the backward through the stage pipeline. The state holds
    this rank's slice (``shard_params_for_pipeline``); ``tokens`` are the
    whole batch on every rank. Each stage's layer gradients stay on it; the
    replicated leaves' are summed over ``pipe``, then every gradient is
    averaged over ``data`` when in-stage DP is on. The loss returned is the
    global one, on every rank."""
    import torch.distributed as dist

    from finchat_tpu_torch.train.train_step import layer_views, named_leaves

    _check_stages(config, mesh)
    del optimizer

    def train_step(state, tokens: torch.Tensor):
        params = state.params
        for _path, leaf in named_leaves(params):
            leaf.requires_grad_(True)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        loss, dp, _rows = _schedule(layer_views(params), tokens, positions, config=config,
                                    mesh=mesh, n_micro=n_micro, remat=remat,
                                    tp_overlap=tp_overlap, tp_chunks=tp_chunks, train=True)
        P = mesh.shape["pipe"]
        if loss is None:
            loss = torch.empty((), dtype=torch.float32, device=tokens.device)
        if P > 1:
            dist.broadcast(loss, src=mesh.peer("pipe", P - 1), group=mesh.group("pipe"))
        _sum_over_pipe(params, mesh)
        if dp > 1:
            mean_grads(params, mesh.group("data"))
            loss = mean_over(loss, mesh.group("data"))
        state.opt_state.step()
        state.step += 1
        return state, loss

    return train_step
