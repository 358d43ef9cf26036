"""IEEE fp32 products on the card, whatever the process-wide TF32 setting.

``torch.backends.cuda.matmul.allow_tf32`` is one flag for the whole
process. ``ieee_fp32()`` turns it off for the products launched inside its
scope and restores it after; one lock serializes the save, set and restore
across every caller and thread (the index's scoring calls from worker
threads, the MoE router in the engine's steps), so no two scopes
interleave. It cannot fence code outside such a scope: a thread that turns
TF32 on while a product is launched inside one makes that product TF32,
and a thread that launches an fp32 product of its own in that window gets
it without TF32. On the CPU the flag changes nothing.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator

import torch

_TF32_LOCK = threading.Lock()


@contextmanager
def ieee_fp32() -> Iterator[None]:
    """fp32 products without TF32 inside the scope (see the module)."""
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
