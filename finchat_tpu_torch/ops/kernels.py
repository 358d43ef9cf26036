"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` into its own shared library with a plain C
interface (one entry point per kernel it holds), loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. No ``--use_fast_math``: the
quantizing kernels rely on IEEE division and round-half-even. Libraries go
to ``finchat_tpu_torch/build/<hash>/`` (listed in ``.gitignore``), keyed by
a hash of every source and header, at first use — one ``nvcc`` per source,
all started together. Nothing here runs at import
time: the CPU tests import every module of the package.

``LAUNCHES`` counts kernel launches per kernel. A wrapper adds one where it
launches its kernel and nowhere else (one C entry point is one launch, even
where it runs a few kernels in a row, as K7's backward, the split decode
attention and the split decode matmul do), so a run can show that the main
path went through the kernels (``chip_smoke.py`` resets the counts before it
drives the path and reads them after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"

# kernel name -> (source file, exported C entry point, argtypes)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNELS: dict[str, tuple[str, str, list]] = {
    "paged_attention": (
        "paged_attention.cu", "paged_attention_bf16",
        # q, k_pages, v_pages, out, part_acc, part_ml, page_table, q_offset, kv_len
        [_P] * 9
        # layer, B, C, H, HKV, D, P, PS, KT, MP, BQ, splits, pages_per_split
        + [_I] * 13 + [_F, _P],  # scale, stream
    ),
    "paged_attention_q8": (
        "paged_attention.cu", "paged_attention_int8",
        # q, k_pages, v_pages, k_scales, v_scales, out, part_acc, part_ml,
        # page_table, q_offset, kv_len
        [_P] * 11
        # layer, B, C, H, HKV, D, P, PS, SPAD, KT, MP, BQ, splits, pages_per_split
        + [_I] * 14 + [_F, _P],  # scale, stream
    ),
    # the Hopper body of int8 calls of 64-row tiles: paged_attention_q8's arguments
    "paged_attention_q8_sm90": (
        "attention_q8_sm90.cu", "paged_attention_int8_sm90", [_P] * 11 + [_I] * 14 + [_F, _P],
    ),
    # the Hopper body of bf16 calls of 64-row tiles: paged_attention's
    # arguments, then the query tiles a block (before scale and stream)
    "paged_attention_sm90": (
        "attention_bf16_sm90.cu", "paged_attention_bf16_sm90",
        [_P] * 9 + [_I] * 13 + [_I] + [_F, _P],
    ),
    # the ragged entry of the bf16 prefill body: ragged_paged_attention's
    # pointers, q_start and q_len [R] after them, its integers, then the
    # tiles a block (a bf16 round's prefill tiles; tiles of one-token rows
    # return at once)
    "ragged_paged_attention_sm90": (
        "attention_bf16_sm90.cu", "ragged_paged_attention_bf16_sm90",
        [_P] * 12 + [_I] * 12 + [_I] + [_F, _P],
    ),
    # the Hopper decode body (C = 1): paged_attention's and paged_attention_q8's arguments
    "paged_attention_decode_sm90": (
        "attention_decode_sm90.cu", "paged_attention_decode_bf16_sm90",
        [_P] * 9 + [_I] * 13 + [_F, _P],
    ),
    "paged_attention_q8_decode_sm90": (
        "attention_decode_sm90.cu", "paged_attention_decode_int8_sm90",
        [_P] * 11 + [_I] * 14 + [_F, _P],
    ),
    # ... and its ragged entry (a bf16 round's one-token rows, each row's
    # pages split over blocks)
    "ragged_paged_attention_decode_sm90": (
        "attention_decode_sm90.cu", "ragged_paged_attention_decode_bf16_sm90",
        # q, k_pages, v_pages, out, part_acc, part_ml, page_table, tok_pos,
        # kv_len, q_start, q_len
        [_P] * 11
        # layer, T, R, H, HKV, D, P, PS, MP, splits, pages_per_split
        + [_I] * 11 + [_F, _P],  # scale, stream
    ),
    "kv_append": (
        "kv_append.cu", "kv_append_bf16",
        # kv_new, k_pages, v_pages, page_table, pos, n_valid
        [_P] * 6
        # layer, B, P, PS, HD, MP
        + [_I] * 6 + [_P],  # stream
    ),
    "kv_append_q8": (
        "kv_append.cu", "kv_append_int8",
        # kv_new, k_pages, v_pages, k_scales, v_scales, page_table, pos, n_valid
        [_P] * 8
        # layer, B, P, PS, HKV, D, SPAD, MP
        + [_I] * 8 + [_P],  # stream
    ),
    # the KV-row writer, every cache write of a serve (decode rows, prefill
    # chunks, ragged rounds) one launch a layer; the int8 entry quantizes
    "kv_append_sm90": (
        "kv_write_sm90.cu", "kv_write_bf16_sm90",
        # k, v, rows, k_pages, v_pages
        [_P] * 5
        # layer, N, P, PS, HD, k_stride, v_stride
        + [_I] * 7 + [_P],  # stream
    ),
    "kv_append_q8_sm90": (
        "kv_write_sm90.cu", "kv_write_int8_sm90",
        # k, v, rows, k_pages, v_pages, k_scales, v_scales
        [_P] * 7
        # layer, N, P, PS, HKV, D, SPAD, k_stride, v_stride
        + [_I] * 9 + [_P],  # stream
    ),
    "ragged_paged_attention": (
        "ragged_paged_attention.cu", "ragged_paged_attention_bf16",
        # q, k_pages, v_pages, out, page_table, tok_pos, kv_len,
        # tile_row, tile_start, tile_len
        [_P] * 10
        # layer, T, R, H, HKV, D, P, PS, KT, MP, NT, BQ
        + [_I] * 12 + [_F, _P],  # scale, stream
    ),
    "ragged_paged_attention_q8": (
        "ragged_paged_attention.cu", "ragged_paged_attention_int8",
        # q, k_pages, v_pages, k_scales, v_scales, out, page_table, tok_pos,
        # kv_len, tile_row, tile_start, tile_len
        [_P] * 12
        # layer, T, R, H, HKV, D, P, PS, SPAD, KT, MP, NT, BQ
        + [_I] * 13 + [_F, _P],  # scale, stream
    ),
    # ... and ragged_paged_attention_q8's
    "ragged_paged_attention_q8_sm90": (
        "attention_q8_sm90.cu", "ragged_paged_attention_int8_sm90",
        [_P] * 12 + [_I] * 13 + [_F, _P],
    ),
    "quant_matmul_int8": (
        "quant_matmul.cu", "quant_matmul_int8",
        # x, q, scale, out; M, K, N, out_f32, x_vec, q_vec
        [_P] * 4 + [_I] * 6 + [_P],  # stream
    ),
    "quant_matmul_int4": (
        "quant_matmul.cu", "quant_matmul_int4",
        # x, q, scale, out; M, K, N, G, out_f32, x_vec, q_vec
        [_P] * 4 + [_I] * 7 + [_P],  # stream
    ),
    "quant_matmul_int8_sm90": (
        "quant_matmul_sm90.cu", "quant_matmul_int8_sm90",
        # x, q, scale, out; M, K, N
        [_P] * 4 + [_I] * 3 + [_P],  # stream
    ),
    "quant_matmul_int4_sm90": (
        "quant_matmul_sm90.cu", "quant_matmul_int4_sm90",
        # x, q, scale, out; M, K, N, G
        [_P] * 4 + [_I] * 4 + [_P],  # stream
    ),
    # the decode body (at most 64 rows, bf16 or fp32 out): the split plan
    # of ops/quant_matmul.decode_split, its fp32 partials in ws
    "quant_matmul_int8_decode_sm90": (
        "quant_matmul_decode_sm90.cu", "quant_matmul_int8_decode_sm90",
        # x, q, scale, out, ws; M, K, N, out_f32, splits, k_split
        [_P] * 5 + [_I] * 6 + [_P],  # stream
    ),
    "quant_matmul_int4_decode_sm90": (
        "quant_matmul_decode_sm90.cu", "quant_matmul_int4_decode_sm90",
        # x, q, scale, out, ws; M, K, N, G, out_f32, splits, k_split
        [_P] * 5 + [_I] * 7 + [_P],  # stream
    ),
    "flash_attention": (
        "flash_attention.cu", "flash_attention_fwd_bf16",
        # q, k, v, out, lse, q_offset, kv_len; B, Sq, Sk, H, HKV, D, causal
        [_P] * 7 + [_I] * 7 + [_F, _P],  # scale, stream
    ),
    # K7's forward on the bf16 prefill body (causal, 64-row tiles):
    # flash_attention's arguments, then the tile tokens and the query tiles
    # a block
    "flash_attention_sm90": (
        "attention_bf16_sm90.cu", "flash_attention_bf16_sm90",
        [_P] * 7 + [_I] * 7 + [_I] * 2 + [_F, _P],
    ),
    "flash_attention_bwd": (
        "flash_attention.cu", "flash_attention_bwd_bf16",
        # q, k, v, out, dout, lse, delta, dq, dk, dv, q_offset, kv_len;
        # B, Sq, Sk, H, HKV, D, causal
        [_P] * 12 + [_I] * 7 + [_F, _P],  # scale, stream
    ),
    # K7's Hopper backward (causal, 64-row tiles): flash_attention_bwd's
    # arguments (a scratch of each query tile's lse and delta in delta's
    # place), then the tile tokens and the dQ pass's query tiles a block
    "flash_attention_bwd_sm90": (
        "flash_attention_bwd_sm90.cu", "flash_attention_bwd_bf16_sm90",
        [_P] * 12 + [_I] * 7 + [_I] * 2 + [_F, _P],
    ),
}
SOURCES = sorted({src for src, _sym, _args in KERNELS.values()})

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_FNS: dict[str, ctypes._CFuncPtr] = {}
BUILD_SECONDS: float | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    """Where the shared library built from ``csrc/<source>`` lives."""
    return BUILD_ROOT / _source_hash() / f"lib{Path(source).stem}.so"


def build_all() -> float:
    """Compile every kernel source that is not built yet (in parallel) and
    load all of them. Returns the wall seconds spent; raises with the
    compiler's output if a build fails."""
    global BUILD_SECONDS
    if len(_FNS) == len(KERNELS):
        return BUILD_SECONDS or 0.0
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        name = Path(src).stem
        so = out_dir / f"lib{name}.so"
        if so.exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    libs = {src: ctypes.CDLL(str(out_dir / f"lib{Path(src).stem}.so")) for src in SOURCES}
    for name, (src, sym, argtypes) in KERNELS.items():
        fn = getattr(libs[src], sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    BUILD_SECONDS = time.perf_counter() - t0
    return BUILD_SECONDS


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point on the current CUDA stream and
    raise if the launch was refused (``cudaGetLastError`` != 0). Counts the
    launch in ``LAUNCHES``."""
    build_all()
    stream = torch.cuda.current_stream().cuda_stream
    err = _FNS[name](*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


@dataclass(frozen=True)
class Prepared:
    """One checked launch of kernel ``name``: its C arguments, its output
    and every tensor the arguments point into (kept alive here), among them
    ``scratch``, the workspace it writes before ``out`` where it has one,
    and ``aux``, what else it writes beside ``out`` where it writes more
    (K7's log-sum-exp; its backward's dk and dv beside dq). ``launch()`` runs it on the current stream and
    returns ``out``; a caller that launches it again reuses the same
    buffers."""

    name: str
    args: tuple
    out: torch.Tensor
    keep: tuple
    scratch: torch.Tensor | None = None
    aux: torch.Tensor | tuple[torch.Tensor, ...] | None = None

    @property
    def parts(self) -> tuple[Prepared, ...]:
        return (self,)

    def launch(self) -> torch.Tensor:
        launch(self.name, *self.args)
        return self.out


@dataclass(frozen=True)
class PreparedSeq:
    """Checked launches that together compute one call into one output
    (``parts``, each a ``Prepared``), run in order on the current stream:
    a bf16 ragged round's prefill tiles, then its one-token rows.
    ``launch()`` runs them all and returns the shared ``out``; each counts
    its own launch."""

    parts: tuple[Prepared, ...]

    @property
    def name(self) -> str:
        return "+".join(p.name for p in self.parts)

    @property
    def out(self) -> torch.Tensor:
        return self.parts[-1].out

    def launch(self) -> torch.Tensor:
        for part in self.parts:
            part.launch()
        return self.out


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
