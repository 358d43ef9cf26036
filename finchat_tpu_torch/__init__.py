"""PyTorch/CUDA port of the finchat serving stack for one NVIDIA H100.

Mirrors the layout of ``finchat_tpu`` (``ops/``, ``models/``, ``engine/``,
``serve/``, ``utils/``, ``io/``) so each module's counterpart sits at the
same relative path. The package imports ``torch`` and numpy only; every
kernel that the JAX package wrote in Pallas is a hand-written CUDA kernel
for ``sm_90a`` here (``csrc/``), built at first use and bound with
``ctypes`` (``ops/kernels.py``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on CPU tensors ``ops/dispatch.py`` runs
each kernel's plain PyTorch version instead.
"""
