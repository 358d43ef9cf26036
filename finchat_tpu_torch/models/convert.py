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

