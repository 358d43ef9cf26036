"""Training step on one card: next-token cross-entropy + AdamW.

The counterpart of the JAX package's ``train/train_step.py``: the same loss
(mean cross-entropy of position t predicting token t+1, over positions
0..S-2), the same optimizer (AdamW, betas 0.9 / 0.95, eps 1e-8, weight decay
on every leaf, moments in the parameter dtype) and per-layer recompute
(``remat``). Every attention call goes through
``models/llama.make_causal_attention``: K7's kernel, forward and backward,
for CUDA tensors, its plain version on the CPU.

In place, as the JAX step donates its state: ``train_step(state, tokens)``
updates the parameters, the moments and the step count of ``state`` and
returns it with the loss (a 0-d tensor, not synchronised).

Memory at 8B. Parameters, gradients and two moments in bf16 are four
copies of the model (~64 GB of the card's 80), so nothing may allocate a
full-size temporary: the optimizer is ``fused`` on the card, and the
gradient of a stacked ``[L, ...]`` layer leaf is written layer by layer into
one stacked buffer through per-layer views (``_backward``) — indexing the
stacked leaf in the forward would make each layer's backward materialise a
zero tensor of the whole stacked shape.

Not ported yet, and refused: a mesh (data / tensor parallelism), ring or
Ulysses sequence parallelism, and MoE configs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator

import torch
import torch.nn.functional as F

from finchat_tpu_torch.models.llama import (
    AttentionFn,
    LlamaConfig,
    forward,
    make_causal_attention,
)


def named_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every leaf of a nested dict, paths joined by
    ``/``."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from named_leaves(value, f"{prefix}{name}/")
        else:
            yield prefix + name, value


@dataclass(frozen=True)
class AdamW:
    """The optimizer's settings (``optax.adamw``'s, as the JAX package
    builds it); ``init`` makes the torch optimizer over a parameter tree."""

    learning_rate: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01

    def init(self, params: dict[str, Any]) -> torch.optim.AdamW:
        """``torch.optim.AdamW`` over every leaf: ``fused`` on the card (no
        full-size temporaries), the single-tensor loop on the CPU."""
        leaves = [leaf for _path, leaf in named_leaves(params)]
        cuda = leaves[0].is_cuda
        return torch.optim.AdamW(leaves, lr=self.learning_rate, betas=(self.b1, self.b2),
                                 eps=self.eps, weight_decay=self.weight_decay,
                                 fused=True if cuda else None, foreach=None if cuda else False)

    @staticmethod
    def load_state(opt: torch.optim.AdamW, leaf: torch.Tensor, count: int,
                   exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor) -> None:
        """Set one leaf's moments and step count (``optax``'s ``count``,
        ``mu``, ``nu``), where the optimizer keeps them."""
        on = leaf.device if opt.defaults["fused"] else "cpu"
        opt.state[leaf] = {"step": torch.tensor(float(count), dtype=torch.float32, device=on),
                           "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}


@dataclass
class TrainState:
    """Parameters (every leaf trained), the optimizer holding their moments,
    and the number of steps taken."""

    params: dict[str, Any]
    opt_state: torch.optim.AdamW
    step: int


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    """AdamW settings as the JAX package's ``make_optimizer``."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay)


def init_train_state(config: LlamaConfig, params: dict[str, Any],
                     optimizer: AdamW) -> TrainState:
    """Mark every leaf of ``params`` as trained (in place) and make zero
    moments for it."""
    for _path, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def loss_fn(params: dict[str, Any], tokens: torch.Tensor, *, config: LlamaConfig,
            attention: AttentionFn, remat: bool) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, S] over positions
    0..S-2 (fp32 logits)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    logits, _ = forward(params, tokens, positions, config=config, attention=attention,
                        remat=remat)
    pred = logits[:, :-1].reshape(-1, logits.shape[-1])
    return F.cross_entropy(pred, tokens[:, 1:].reshape(-1).long())


def _backward(params: dict[str, Any], tokens: torch.Tensor, *, config: LlamaConfig,
              attention: AttentionFn, remat: bool) -> torch.Tensor:
    """Loss forward and backward with every leaf's gradient in its
    ``.grad``. A stacked layer leaf's ``.grad`` is one buffer (made on the
    first call, zeroed on later ones); the forward reads per-layer views of
    the leaf whose ``.grad`` are views of that buffer, so autograd adds each
    layer's gradient in place. Other leaves get a fresh gradient."""
    layers = {}
    for name, leaf in params["layers"].items():
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        else:
            leaf.grad.zero_()
        views = []
        for i in range(config.n_layers):
            w = leaf.detach()[i].requires_grad_()
            w.grad = leaf.grad[i]
            views.append(w)
        layers[name] = views
    for name, leaf in params.items():
        if name != "layers":
            leaf.grad = None
    loss = loss_fn({**params, "layers": layers}, tokens, config=config, attention=attention,
                   remat=remat)
    loss.backward()
    return loss.detach()


def value_and_grad(params: dict[str, Any], tokens: torch.Tensor, *, config: LlamaConfig,
                   attention: AttentionFn | None = None,
                   remat: bool = True) -> tuple[torch.Tensor, dict[str, Any]]:
    """``(loss, grads)`` with grads a tree shaped like ``params`` (the
    counterpart of ``jax.value_and_grad`` of the JAX step's loss).
    ``attention`` defaults to ``make_causal_attention()``; a plain callback
    (``dense_causal_attention``) gives the reference gradient. The leaves'
    ``.grad`` are handed over and left unset."""
    for _path, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    loss = _backward(params, tokens, config=config,
                     attention=attention or make_causal_attention(), remat=remat)

    def take(tree):
        out = {}
        for name, value in tree.items():
            if isinstance(value, dict):
                out[name] = take(value)
            else:
                out[name], value.grad = value.grad, None
        return out

    return loss, take(params)


def make_train_step(
    config: LlamaConfig,
    optimizer: AdamW,
    mesh: Any = None,
    *,
    use_ring_attention: bool = False,
    sp_mode: str = "ring",
    remat: bool = True,
):
    """Build ``train_step(state, tokens) -> (state, loss)``. ``optimizer``
    is the one ``init_train_state`` bound to the state (kept in the JAX
    signature). Planes not ported yet raise ``NotImplementedError``."""
    if config.n_experts:
        raise NotImplementedError("MoE layers are not ported yet (n_experts must be 0)")
    if mesh is not None:
        raise NotImplementedError("training over a mesh (data / tensor parallelism) is not "
                                  "ported yet: the train step runs on one card")
    if use_ring_attention:
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_mode {sp_mode!r} (want 'ring' or 'ulysses')")
        raise NotImplementedError(f"sequence parallelism ({sp_mode}) is not ported yet")
    del optimizer
    attention = make_causal_attention()

    def train_step(state: TrainState, tokens: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
        loss = _backward(state.params, tokens, config=config, attention=attention, remat=remat)
        state.opt_state.step()
        state.step += 1
        return state, loss

    return train_step
