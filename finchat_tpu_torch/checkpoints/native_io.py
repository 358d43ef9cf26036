"""Native checkpoints of the port's trees: the counterpart of the JAX
package's ``checkpoints/orbax_io.py``, without Orbax.

- ``save_pytree(path, tree)`` writes a directory: ``tensors.safetensors``
  (the port's own writer, one tensor at a time) and ``manifest.json``,
  which records every leaf by its ``/``-joined path and kind. A tensor is
  stored under its path; a quantized leaf (``QTensor``/``Q4Tensor``) as
  ``<path>.q`` and ``<path>.scale`` with its class named in the manifest; a
  Python scalar (a step count) in the manifest itself.
- The write is atomic: everything goes to a sibling temporary directory,
  which then takes the checkpoint's name by ``os.replace`` (an existing
  checkpoint is first renamed aside, and removed once the new one is in
  place), so a save that fails mid-write leaves the previous checkpoint
  restorable. ``force`` as Orbax's: an existing ``path`` is replaced, or
  with ``force=False`` refused.
- ``restore_pytree(path, like)`` gives a tree shaped like ``like``: each
  leaf on ``like``'s device in ``like``'s dtype, its shape checked; a leaf
  missing, of another kind or of another shape raises, naming the leaf.
- ``save_train_state`` / ``restore_train_state`` carry the port's
  ``train/train_step.TrainState``: the parameters, each leaf's AdamW
  ``step``/``exp_avg``/``exp_avg_sq`` (set back through
  ``AdamW.load_state``, as ``models/convert.train_state_from_numpy`` does)
  and the step count.

One process, one device: the JAX package's sharded placement has no
counterpart until the parallel plane is ported.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Iterator

import torch

from finchat_tpu_torch.checkpoints.safetensors_io import SafeTensorsFile, save_file
from finchat_tpu_torch.models.quant import Q4Tensor, QTensor
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MANIFEST = "manifest.json"
TENSORS = "tensors.safetensors"
_SCALARS = (bool, int, float)


def _leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` over a nested dict, paths joined by ``/``."""
    if not isinstance(tree, dict):
        yield prefix.rstrip("/"), tree
        return
    for key, value in tree.items():
        if not isinstance(key, str) or "/" in key or "." in key:
            raise ValueError(f"checkpoint tree key {key!r} at {prefix or '/'}: keys must be "
                             "strings without '/' or '.'")
        yield from _leaves(value, f"{prefix}{key}/")


def save_pytree(path: str | Path, tree: Any, *, force: bool = True) -> None:
    """Persist a tree of tensors, quantized leaves and scalars at ``path``."""
    path = Path(path).resolve()
    if path.exists() and not force:
        raise ValueError(f"Destination {path} already exists.")
    manifest: dict[str, dict] = {}
    tensors: dict[str, torch.Tensor] = {}
    for name, leaf in _leaves(tree):
        if isinstance(leaf, (QTensor, Q4Tensor)):
            manifest[name] = {"kind": type(leaf).__name__}
            tensors[name + ".q"], tensors[name + ".scale"] = leaf.q, leaf.scale
        elif isinstance(leaf, torch.Tensor):
            manifest[name] = {"kind": "tensor"}
            tensors[name] = leaf
        elif isinstance(leaf, _SCALARS):
            manifest[name] = {"kind": type(leaf).__name__, "value": leaf}
        else:
            raise TypeError(f"checkpoint leaf {name!r}: {type(leaf).__name__} is not a tensor, "
                            "a quantized tensor or a scalar")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{path.name}.", suffix=".tmp", dir=path.parent))
    try:
        save_file(tensors, tmp / TENSORS)
        (tmp / MANIFEST).write_text(json.dumps({"leaves": manifest}, indent=1))
        old = None
        if path.exists():
            old = tmp.with_name(tmp.name[:-len(".tmp")] + ".old")
            os.replace(path, old)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    logger.info("checkpoint saved to %s", path)


def _restore_tensor(name: str, like: torch.Tensor, store: SafeTensorsFile) -> torch.Tensor:
    if name not in store:
        raise KeyError(f"checkpoint has no tensor {name!r}")
    _dtype, shape = store.dtype_shape(name)
    if tuple(shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {name!r} has shape {list(shape)}, the tree wants "
                         f"{list(like.shape)}")
    return store.read(name, lambda t: t.to(device=like.device, dtype=like.dtype, copy=True))


def restore_pytree(path: str | Path, like: Any) -> Any:
    """A tree shaped like ``like`` from the checkpoint at ``path``, each
    leaf on ``like``'s device in ``like``'s dtype."""
    path = Path(path).resolve()
    manifest = json.loads((path / MANIFEST).read_text())["leaves"]
    store = SafeTensorsFile(path / TENSORS)

    def restore(name: str, leaf: Any) -> Any:
        entry = manifest.get(name)
        if entry is None:
            raise KeyError(f"checkpoint at {path} has no leaf {name!r}")
        want = (type(leaf).__name__ if isinstance(leaf, (QTensor, Q4Tensor, *_SCALARS))
                else "tensor")
        if entry["kind"] != want:
            raise ValueError(f"checkpoint leaf {name!r} is a {entry['kind']}, the tree wants a "
                             f"{want}")
        if isinstance(leaf, (QTensor, Q4Tensor)):
            return type(leaf)(q=_restore_tensor(name + ".q", leaf.q, store),
                              scale=_restore_tensor(name + ".scale", leaf.scale, store))
        if isinstance(leaf, _SCALARS):
            return type(leaf)(entry["value"])
        return _restore_tensor(name, leaf, store)

    def walk(tree: Any, prefix: str) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        return restore(prefix.rstrip("/"), tree)

    try:
        out = walk(like, "")
    finally:
        store.close()
    logger.info("checkpoint restored from %s", path)
    return out


def _put(tree: dict, path: str, value: Any) -> None:
    """``tree[a][b][c] = value`` for ``path`` ``a/b/c``."""
    *parents, last = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = value


def _train_tree(state: Any) -> dict:
    """The state as one tree: params, each leaf's AdamW moments (where the
    optimizer has them) and the step count."""
    from finchat_tpu_torch.train.train_step import named_leaves

    moments: dict[str, Any] = {}
    for name, leaf in named_leaves(state.params):
        st = state.opt_state.state.get(leaf)
        if st:
            _put(moments, name, {"step": int(st["step"].item()), "exp_avg": st["exp_avg"],
                                 "exp_avg_sq": st["exp_avg_sq"]})
    return {"params": state.params, "opt_state": moments, "step": int(state.step)}


def save_train_state(path: str | Path, state: Any) -> None:
    """Persist a ``train/train_step.TrainState`` (params, AdamW state, step)
    under ``path/train_state``."""
    save_pytree(Path(path) / "train_state", _train_tree(state))


def restore_train_state(path: str | Path, like_state: Any):
    """A new ``TrainState`` restored into the structure of ``like_state``
    (the same optimizer settings; its leaves' devices and dtypes): fresh
    parameter tensors, an AdamW over them holding the saved moments, and
    the saved step."""
    from finchat_tpu_torch.train.train_step import AdamW, init_train_state, named_leaves

    path = Path(path) / "train_state"
    saved = json.loads((path / MANIFEST).read_text())["leaves"]
    # the moments the checkpoint holds, each shaped like its parameter
    moments: dict[str, Any] = {}
    for name, leaf in named_leaves(like_state.params):
        if f"opt_state/{name}/step" in saved:
            _put(moments, name, {"step": 0, "exp_avg": leaf.detach(),
                                 "exp_avg_sq": leaf.detach()})
    restored = restore_pytree(path, {"params": like_state.params, "opt_state": moments,
                                     "step": 0})
    defaults = like_state.opt_state.defaults
    optimizer = AdamW(learning_rate=defaults["lr"], b1=defaults["betas"][0],
                      b2=defaults["betas"][1], eps=defaults["eps"],
                      weight_decay=defaults["weight_decay"])
    state = init_train_state(None, restored["params"], optimizer)
    for name, leaf in named_leaves(state.params):
        if f"opt_state/{name}/step" in saved:
            node = restored["opt_state"]
            for part in name.split("/"):
                node = node[part]
            optimizer.load_state(state.opt_state, leaf, node["step"], node["exp_avg"],
                                 node["exp_avg_sq"])
    state.step = restored["step"]
    return state
