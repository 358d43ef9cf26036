"""Parameter-tree conversion from the JAX package's layout, bit for bit.

``params_from_numpy(tree, device)`` takes the JAX package's parameter tree
with every leaf already a numpy array (``jax.device_get`` of the tree) and
returns the port's tree of torch tensors with the same nesting and shapes.
bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which torch cannot
read directly; their bytes go through a ``uint16 -> int16 ->
torch.bfloat16`` view, never through float32, so every bit survives.
The JAX package's quantized leaves (``QTensor`` / ``Q4Tensor``, recognised
by their class name and their ``q`` / ``scale`` fields, without importing
that package) become the port's classes of the same name, bit for bit.

``train_state_from_numpy(state, device)`` converts the JAX package's
``TrainState`` (params, the optax AdamW state, step) the same way: optax's
``ScaleByAdamState`` ``count`` / ``mu`` / ``nu`` become each leaf's
``step`` / ``exp_avg`` / ``exp_avg_sq`` in the port's optimizer, so a JAX
run resumes in the port from the same bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from finchat_tpu_torch.models.quant import Q4Tensor, QTensor

_QUANT_CLASSES = {"QTensor": QTensor, "Q4Tensor": Q4Tensor}


def _leaf(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable and owned by the tensor
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device: torch.device | str) -> Any:
    """Convert a (nested dict of) numpy leaves to torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    cls = _QUANT_CLASSES.get(type(tree).__name__)
    if cls is not None and hasattr(tree, "q") and hasattr(tree, "scale"):
        return cls(q=_leaf(np.asarray(tree.q), device), scale=_leaf(np.asarray(tree.scale), device))
    return _leaf(np.asarray(tree), device)



def _adam_state(opt_state: Any) -> Any:
    """optax's ``ScaleByAdamState`` inside the chained optimizer state,
    recognised by its fields (``count``, ``mu``, ``nu``)."""
    for part in opt_state if isinstance(opt_state, tuple) else (opt_state,):
        if all(hasattr(part, f) for f in ("count", "mu", "nu")):
            return part
    raise ValueError("no AdamW moments (count, mu, nu) in the optimizer state")


def train_state_from_numpy(state: Any, device: torch.device | str, optimizer: Any = None) -> Any:
    """The JAX package's ``TrainState`` (numpy leaves, ``jax.device_get``)
    as the port's ``train/train_step.TrainState``: the same parameters,
    moments and step count, bit for bit. ``optimizer`` is the port's
    ``make_optimizer()`` settings (its defaults when omitted)."""
    from finchat_tpu_torch.train.train_step import AdamW, init_train_state, named_leaves

    optimizer = optimizer or AdamW()
    adam = _adam_state(state.opt_state)
    mu = dict(named_leaves(params_from_numpy(adam.mu, device)))
    nu = dict(named_leaves(params_from_numpy(adam.nu, device)))
    out = init_train_state(None, params_from_numpy(state.params, device), optimizer)
    count = int(np.asarray(adam.count))
    for path, leaf in named_leaves(out.params):
        optimizer.load_state(out.opt_state, leaf, count, mu[path], nu[path])
    out.step = int(np.asarray(state.step))
    return out
