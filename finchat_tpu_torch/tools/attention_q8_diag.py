"""Where the int8-KV attention kernels spend their time, on one H100.

    python -m finchat_tpu_torch.tools.attention_q8_diag

Times, at the serving shapes of ``chip_smoke.py`` (Llama-3-8B heads, page
128; prefill 4 x 512 at q_offset 0, 1024 and 2048; the ragged round of two
512-token rows and 60 decode rows), the older int8 body
(``paged_attention.cu`` / ``ragged_paged_attention.cu``), the Hopper body
(``attention_q8_sm90.cu``) and three diagnostic builds of them, each a copy
of the sources with one stage cut out by text substitution (the script
fails if a substitution no longer matches):

- ``old, staging from constants``: the older body's tensor-core tiles
  filled with a constant instead of the loaded, dequantized K/V;
- ``new, no conversion``: the Hopper body without its dequantization;
- ``new, products only``: the Hopper body without its fetches and its
  dequantization — the products and the softmax alone.

The diagnostic builds compute garbage and are only timed. Every time is
the median over 20 CUDA-event-timed runs of back-to-back launches (each
launch prepared once, ``prepare_paged``/``prepare_ragged``); nvcc's register
and spill counts of each build are printed. Needs a CUDA device and nvcc;
writes its builds under ``finchat_tpu_torch/build/diag/``.
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import statistics
import subprocess
import sys

import torch

from finchat_tpu_torch.engine.kv_cache import quantize_kv_rows, scale_rows
from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops.paged_attention import prepare_paged
from finchat_tpu_torch.ops.ragged_paged_attention import prepare_ragged

H, HKV, D, PS, MP = 32, 8, 128, 128, 64

# (source file, text to cut, its replacement) per diagnostic build
_OLD_STAGING = [
    ("attention_common.cuh",
     "*reinterpret_cast<uint4*>(Ks + t * ST + c * 8) = kv.k8(phys, off0 + t, g, c);",
     "*reinterpret_cast<uint4*>(Ks + t * ST + c * 8) = make_uint4(0x3c003c00u + (unsigned)phys,"
     " 0x3c003c00u, 0x3c003c00u, 0x3c003c00u);"),
    ("attention_common.cuh",
     "*reinterpret_cast<uint4*>(Vs + t * ST + c * 8) = kv.v8(phys, off0 + t, g, c);",
     "*reinterpret_cast<uint4*>(Vs + t * ST + c * 8) = make_uint4(0x3c003c00u, 0x3c003c00u,"
     " 0x3c003c00u, 0x3c003c00u);"),
]
_NO_CONVERSION = [
    ("attention_q8_sm90.cu",
     "    if (WG == 1 || wg == 0) dequant_k(stage, sm + KT_OFF, wtid);\n"
     "    if (WG == 1 || wg == 1) dequant_vt(stage, sm + VT_OFF, wtid);\n", ""),
]
_PRODUCTS_ONLY = _NO_CONVERSION + [
    ("attention_q8_sm90.cu",
     "      fetch_tile<NT>(kv, pt_row, nt * kKeys, g, base + RING_OFF + ns * RAW_STAGE,"
     " bars + 8 * ns,\n                     tid);\n", ""),
    ("attention_q8_sm90.cu", "    fct::mbar_wait(bars + 8 * s, (t / kStages) & 1);\n", ""),
    ("attention_q8_sm90.cu",
     "    fetch_tile<NT>(kv, pt_row, t * kKeys, g, base + RING_OFF + t * RAW_STAGE,"
     " bars + 8 * t, tid);\n", ""),
]


def build_variant(name: str, source: str, cuts) -> ctypes.CDLL:
    """A copy of csrc/ with ``cuts`` applied, ``source`` built into a library."""
    out = kernels.BUILD_ROOT / "diag" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(kernels.CSRC, out)
    for file, old, new in cuts:
        text = (out / file).read_text()
        if old not in text:
            raise SystemExit(f"{name}: {file} no longer holds the text this build cuts")
        (out / file).write_text(text.replace(old, new))
    lib = out / f"lib{name}.so"
    proc = subprocess.run(
        [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(out), "-o", str(lib),
         str(out / source)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    usage = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(f"  {name}: " + "; ".join(usage))
    return ctypes.CDLL(str(lib))


def time_ms(fn, iters: int = 20) -> float:
    """Median ms of one call over ``iters`` runs of back-to-back calls
    filling about a millisecond."""

    def run(reps: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    reps = max(1, min(20, int(1.0 / max(run(1), 0.05))))
    return statistics.median(run(reps) / reps for _ in range(iters))


@contextlib.contextmanager
def kernel_from(name: str, lib: ctypes.CDLL | None):
    """Kernel ``name``'s launches go to ``lib``'s entry point (the built one
    if None) inside the block."""
    kept = kernels._FNS[name]
    if lib is not None:
        _src, sym, argtypes = kernels.KERNELS[name]
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        kernels._FNS[name] = fn
    try:
        yield
    finally:
        kernels._FNS[name] = kept


def timed(launch, name: str, lib: ctypes.CDLL | None) -> float:
    """Time a prepared launch of kernel ``name``, from ``lib`` if given."""
    with kernel_from(name, lib):
        return time_ms(launch)


def _cache(gen, dev, n_pages: int):
    """An int8 cache of one layer pair with its scale planes, from random rows."""
    planes = []
    for _ in range(2):
        q, s = quantize_kv_rows(torch.randn((2, n_pages, PS, HKV * D), generator=gen, device=dev,
                                            dtype=torch.bfloat16), HKV)
        sp = torch.zeros((2, n_pages, scale_rows(HKV), PS), device=dev)
        sp[:, :, :HKV] = s.transpose(2, 3)
        planes.append((q, sp))
    (k, ks), (v, vs) = planes
    return k, v, ks, vs


def _page_table(gen, dev, kv_lens, n_pages: int) -> torch.Tensor:
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev).to(torch.int32) + 1
    pt = torch.zeros((len(kv_lens), MP), dtype=torch.int32, device=dev)
    nxt = 0
    for b, n in enumerate(kv_lens):
        k = max(1, -(-n // PS))
        pt[b, :k] = perm[nxt:nxt + k]
        nxt += k
    return pt


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"{torch.cuda.get_device_name(0)} ({smi.stdout.strip()})")
    kernels.build_all()
    print("builds:")
    old_consts = {src: build_variant(f"old_staging_{src.split('.')[0]}", src, _OLD_STAGING)
                  for src in ("paged_attention.cu", "ragged_paged_attention.cu")}
    no_conv = build_variant("new_no_conversion", "attention_q8_sm90.cu", _NO_CONVERSION)
    products = build_variant("new_products_only", "attention_q8_sm90.cu", _PRODUCTS_ONLY)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    kw = dict(page_size=PS, n_kv=HKV)
    cases = []
    for q_off in (0, 1024, 2048):
        kv_lens = [q_off + 512] * 4
        n_pages = 2 + sum(-(-n // PS) for n in kv_lens)
        k, v, ks, vs = _cache(gen, dev, n_pages)
        q = torch.randn((4, 512, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
        args = (q, k, v, _page_table(gen, dev, kv_lens, n_pages),
                torch.full((4,), q_off, dtype=torch.int32, device=dev),
                torch.tensor(kv_lens, dtype=torch.int32, device=dev), 1)
        cases.append((f"paged prefill 4x512 at q{q_off}", "paged_attention_q8",
                      "paged_attention.cu", lambda name, a=args, s=(ks, vs): prepare_paged(
                          name, *a, **kw, k_scales=s[0], v_scales=s[1], route=False).launch))
    R, T = 64, 2048
    dec = [int(x) for x in torch.randint(1, 4096, (60,), generator=gen, device=dev)]
    spans = [(512, 0), (512, 1024)] + [(1, n - 1) for n in dec] + [(0, 0), (0, 0)]
    kv_lens = [a + b for a, b in spans[:62]] + [0, 0]
    n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
    k, v, ks, vs = _cache(gen, dev, n_pages)
    tok_row = [r for r, (n, _p) in enumerate(spans) for _ in range(n)]
    tok_pos = [p + i for n, p in spans for i in range(n)]
    tok_row += [R] * (T - len(tok_row))
    tok_pos += [0] * (T - len(tok_pos))
    args = (torch.randn((T, H, D), generator=gen, device=dev, dtype=torch.bfloat16), k, v,
            _page_table(gen, dev, kv_lens, n_pages),
            torch.tensor(tok_row, dtype=torch.int32, device=dev),
            torch.tensor(tok_pos, dtype=torch.int32, device=dev),
            torch.tensor(kv_lens, dtype=torch.int32, device=dev), 1)
    cases.append(("ragged round 2x512 + 60 decode rows", "ragged_paged_attention_q8",
                  "ragged_paged_attention.cu",
                  lambda name, a=args, s=(ks, vs): prepare_ragged(
                      name, *a, **kw, k_scales=s[0], v_scales=s[1], route=False).launch))

    for label, old, old_src, make in cases:
        new = f"{old}_sm90"
        print(f"{label} (ms):")
        rows = [("old body", old, None), ("old, staging from constants", old, old_consts[old_src]),
                ("new body", new, None), ("new, no conversion", new, no_conv),
                ("new, products only", new, products), ("old body, again", old, None)]
        for row, name, lib in rows:
            print(f"  {row}: {timed(make(name), name, lib):.4f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
