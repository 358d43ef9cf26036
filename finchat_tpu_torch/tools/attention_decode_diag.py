"""What paces the Hopper decode attention body, on one H100.

    python -m finchat_tpu_torch.tools.attention_decode_diag

Times, for each cache (bf16 and int8 with its scale planes) at the decode
shapes of ``chip_smoke.py`` (Llama-3-8B heads, page 128, 64 pages a
sequence) — B=64 over 1-4k tokens, and the serve's 8 sequences at 5,236
tokens as a B=8 call and inside the serve's B=64 call (56 empty slots) —
the decode body (``csrc/attention_decode_sm90.cu``), the older body
(``csrc/paged_attention.cu``) on the same inputs, and three diagnostic
builds of the decode body:

- ``no fetch``: ``-DFCT_DECODE_NO_FETCH``, no copies: the ring is read as
  it stands, so what is left is the conversion, the products and the
  softmax;
- ``no products``: ``-DFCT_DECODE_NO_PRODUCTS``, the fragments read (and
  for int8 converted) but no ``mma``: the fetch and the conversion;
- ``neither``: both, what the pipeline, barriers and launch cost alone.

Then the split: the decode body at each of ``SWEEP_PAGES`` pages a split in
place of ``decode_split``'s choice, on the same inputs.

The diagnostic builds compute garbage and are only timed. Each time is the
median over 20 CUDA-event-timed runs of back-to-back launches (each launch
prepared once with ``prepare_paged``), beside the bytes bound (each live
key's K and V read once, 512 bytes a key and KV head in bf16, 264 in int8
with its scales, over 3.35 TB/s); nvcc's register and spill counts of each
build are printed. Needs a CUDA device and nvcc; writes its builds under
``finchat_tpu_torch/build/diag/``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops import paged_attention as pa
from finchat_tpu_torch.ops.paged_attention import decode_split, prepare_paged, sm_count
from finchat_tpu_torch.tools.attention_q8_diag import _cache as _q8_cache
from finchat_tpu_torch.tools.attention_q8_diag import _page_table, timed

H, HKV, D, PS, MP = 32, 8, 128, 128, 64
SOURCE = "attention_decode_sm90.cu"
VARIANTS = {"no fetch": ["-DFCT_DECODE_NO_FETCH"], "no products": ["-DFCT_DECODE_NO_PRODUCTS"],
            "neither": ["-DFCT_DECODE_NO_FETCH", "-DFCT_DECODE_NO_PRODUCTS"]}
SWEEP_PAGES = (2, 4, 6, 8, 11, 13, 16, 22, 32, 64)


def build_variant(name: str, defines: list[str]) -> ctypes.CDLL:
    """``csrc/attention_decode_sm90.cu`` built with ``defines`` into a library."""
    out = kernels.BUILD_ROOT / "diag" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libdecode.so"
    proc = subprocess.run(
        [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *defines, "-I", str(kernels.CSRC),
         "-o", str(lib), str(kernels.CSRC / SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    usage = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(f"  {name}: " + "; ".join(usage))
    return ctypes.CDLL(str(lib))


def _bf16_cache(gen, dev, n_pages: int):
    shape = (2, n_pages, PS, HKV * D)
    return (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16),
            torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16), None, None)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"{torch.cuda.get_device_name(0)} ({smi.stdout.strip()})")
    kernels.build_all()
    print("builds:")
    libs = {name: build_variant(name, defines) for name, defines in VARIANTS.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    b64 = [int(x) for x in torch.randint(1, 4097, (64,), generator=gen, device=dev)]
    cases = [("B=64 over 1-4k", b64), ("B=8 at 5,236", [5236] * 8),
             ("the serve's B=64: 8 at 5,236, 56 empty", [5236] * 8 + [0] * 56)]
    for q8 in (False, True):
        kind = "paged_attention_q8" if q8 else "paged_attention"
        for label, kv_lens in cases:
            n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
            k, v, ks, vs = (_q8_cache if q8 else _bf16_cache)(gen, dev, n_pages)
            B = len(kv_lens)
            kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
            args = (torch.randn((B, 1, H, D), generator=gen, device=dev, dtype=torch.bfloat16),
                    k, v, _page_table(gen, dev, kv_lens, n_pages), (kl - 1).clamp(min=0), kl, 1)
            kw = dict(page_size=PS, n_kv=HKV)
            if q8:
                kw.update(k_scales=ks, v_scales=vs)
            splits, pps = decode_split(B, HKV, MP, PS, sm_count(dev))
            bound = sum(kv_lens) * HKV * ((D + 4) * 2 if q8 else D * 4) / 3.35e12 * 1e3
            print(f"{kind} decode, {label} (ms; split {splits} x {pps} pages; bytes bound "
                  f"{bound:.4f}):", flush=True)
            new = prepare_paged(kind, *args, **kw)
            old = prepare_paged(kind, *args, **kw, route=False)
            rows = [("decode body", new.name, new, None)]
            rows += [(f"decode body, {name}", new.name, new, lib) for name, lib in libs.items()]
            rows += [("older body", old.name, old, None), ("decode body, again", new.name, new,
                                                           None)]
            for row, name, call, lib in rows:
                print(f"  {row}: {timed(call.launch, name, lib):.4f}", flush=True)
            sweep = []
            try:
                for pps in SWEEP_PAGES:
                    pa.decode_split = lambda *_a, p=pps: (-(-MP // p), p)
                    call = prepare_paged(kind, *args, **kw)
                    sweep.append(f"{pps} {timed(call.launch, call.name, None):.4f}")
            finally:
                pa.decode_split = decode_split
            print("  pages a split, ms: " + ", ".join(sweep), flush=True)
            del k, v, ks, vs, args, new, old
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
