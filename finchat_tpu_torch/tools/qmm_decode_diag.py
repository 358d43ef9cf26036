"""What paces the Hopper decode body of the fused dequant matmul, on one H100.

    python -m finchat_tpu_torch.tools.qmm_decode_diag

Times, at the engine's decode batch (M = 64 rows of x), the decode body
(``csrc/quant_matmul_decode_sm90.cu``) on llama3-8b's int8 weights — k and v
``[4096, 1024]``, gate and up ``[4096, 14336]``, down ``[14336, 4096]`` and
the head ``[4096, 128256]`` with fp32 output — and on int4 per group of 128
at ``[4096, 14336]``; beside it v2 (``csrc/quant_matmul.cu``) and
``torch.matmul`` on the dequantized bf16 weight, on the same inputs, and
five diagnostic builds of the body:

- ``no fetch``: ``-DFCT_QMM_NO_FETCH``, no TMA: the ring is read as it
  stands, so what is left is the conversion, the products and the sum;
- ``no products``: ``-DFCT_QMM_NO_PRODUCTS``, the fragments read and
  converted but no ``mma``;
- ``no reduce``: ``-DFCT_QMM_NO_REDUCE``, the splits' partials written but
  never summed (the second kernel not launched);
- ``neither``: no fetch and no products: the conversion with the ring's
  barriers, the block's prologue and epilogue and the launch;
- ``fetch only``: ``-DFCT_QMM_NO_DEQUANT``, the ring streams the weight and
  x and nothing reads it: what the copies alone take.

Then the body with the splits forced to each of ``SWEEP_SPLITS`` in place of
``decode_split``'s choice, on the same inputs.

The diagnostic builds compute garbage and are only timed. Each time is the
median over 20 CUDA-event-timed runs of back-to-back launches (each launch
prepared once with ``prepare``), then after a slash the time a launch of 20
launches captured in one CUDA graph and replayed (median of 20 replays: no
host work between launches, which paces the small shapes' runs), beside
the bytes bound (x, the stored weight and its scales read once, the output
written once, over 3.35 TB/s);
nvcc's register and spill counts of each build are printed. Needs a CUDA
device and nvcc; writes its builds under ``finchat_tpu_torch/build/diag/``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from finchat_tpu_torch.models.quant import dequantize, quantize, quantize_int4
from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops import quant_matmul as qmm
from finchat_tpu_torch.tools.attention_q8_diag import time_ms

SOURCE = "quant_matmul_decode_sm90.cu"
VARIANTS = {"body": [], "no fetch": ["-DFCT_QMM_NO_FETCH"],
            "no products": ["-DFCT_QMM_NO_PRODUCTS"], "no reduce": ["-DFCT_QMM_NO_REDUCE"],
            "neither": ["-DFCT_QMM_NO_FETCH", "-DFCT_QMM_NO_PRODUCTS"],
            "fetch only": ["-DFCT_QMM_NO_DEQUANT"]}
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 11, 16, 22, 32)
M = 64
# (label, K, N, mode, group, fp32 out)
CASES = [("k/v int8", 4096, 1024, "int8", 0, False),
         ("q/o int8", 4096, 4096, "int8", 0, False),
         ("gate/up int8", 4096, 14336, "int8", 0, False),
         ("down int8", 14336, 4096, "int8", 0, False),
         ("head int8, fp32 out", 4096, 128256, "int8", 0, True),
         ("gate/up int4 g128", 4096, 14336, "int4", 128, False)]


def build_variant(name: str, defines: list[str]) -> ctypes.CDLL:
    """``csrc/quant_matmul_decode_sm90.cu`` built with ``defines`` into a
    library; prints ptxas's registers and spills of each kernel."""
    out = kernels.BUILD_ROOT / "diag" / ("qmm_" + name.replace(" ", "_"))
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libqmm_decode.so"
    proc = subprocess.run(
        [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *defines, "-I", str(kernels.CSRC),
         "-o", str(lib), str(kernels.CSRC / SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs, spills, serialized, kernel = set(), [], set(), ""
    for ln in (ln.strip() for ln in proc.stderr.splitlines()):
        if "Function properties for" in ln:
            kernel = ln.split("for ")[-1]
        elif "Used" in ln and "registers" in ln:
            regs.add(int(ln.split("Used ")[1].split()[0]))
        elif "spill" in ln and not ln.startswith("0 bytes stack frame, 0 bytes spill"):
            spills.append(f"{kernel[:60]}: {ln}")
        elif "C751" in ln:  # ptxas serializes wgmma: it could not prove a register safe
            serialized.add(ln.split("Potential")[0] + ln.split("function")[-1][:70])
    print(f"  {name}: registers {sorted(regs)}; "
          + ("; ".join(spills) if spills else "no spill")
          + ("; " + "; ".join(sorted(serialized)) if serialized else ""), flush=True)
    return ctypes.CDLL(str(lib))


def graph_ms(fn, launches: int = 20, iters: int = 20) -> float:
    """Median ms per launch of ``fn`` over ``iters`` replays of one CUDA
    graph holding ``launches`` calls of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters + 2):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times[2:])


def _timed2(launch, name: str, lib: ctypes.CDLL | None) -> str:
    """Event-timed and graph-timed ms of a prepared launch of kernel
    ``name``, from ``lib`` if given."""
    kept = kernels._FNS[name]
    if lib is not None:
        _src, sym, argtypes = kernels.KERNELS[name]
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        kernels._FNS[name] = fn
    try:
        return f"{time_ms(launch):.4f} / {graph_ms(launch):.4f}"
    finally:
        kernels._FNS[name] = kept


def _forced(splits: int):
    """A ``decode_split`` that gives ``splits`` splits of whole 64-row tiles
    (fewer where K has fewer tiles)."""
    def plan(K, N, group, n_sm):
        tiles = -(-K // qmm.DECODE_TILE_K)
        per = -(-tiles // min(splits, tiles))
        return -(-tiles // per), per * qmm.DECODE_TILE_K
    return plan


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
    for label, K, N, mode, group, f32 in CASES:
        w = torch.randn((K, N), generator=gen, device=dev, dtype=torch.bfloat16).mul_(K ** -0.5)
        qt = quantize_int4(w, group) if mode == "int4" else quantize(w)
        del w
        x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
        out_dtype = torch.float32 if f32 else torch.bfloat16
        name, v2 = f"quant_matmul_{mode}_decode_sm90", f"quant_matmul_{mode}"
        splits, k_split = qmm.decode_split(K, N, group or K, qmm._sm_count(0))
        moved = (x.numel() * 2 + qt.q.numel() + qt.scale.numel() * 4
                 + M * N * (4 if f32 else 2))
        print(f"{label} [{K}, {N}], M={M} (ms; {splits} splits of {k_split}; bytes bound "
              f"{moved / 3.35e12 * 1e3:.4f}):", flush=True)
        call = qmm.prepare(name, x, qt.q, qt.scale, out_dtype=out_dtype)
        rows = [(f"decode body, {v}" if v != "body" else "decode body", name, call, lib)
                for v, lib in libs.items()]
        rows.append(("v2", v2, qmm.prepare(v2, x, qt.q, qt.scale, out_dtype=out_dtype), None))
        for row, kname, c, lib in rows:
            print(f"  {row}: {_timed2(c.launch, kname, lib)}", flush=True)
        w_deq = dequantize(qt, torch.bfloat16)
        library = ((lambda: torch.mm(x, w_deq, out_dtype=torch.float32)) if f32
                   else (lambda: torch.matmul(x, w_deq)))
        print(f"  torch.{'mm' if f32 else 'matmul'} on the dequantized weight: "
              f"{time_ms(library):.4f} / {graph_ms(library):.4f}", flush=True)
        del w_deq, library
        sweep = []
        plan = qmm.decode_split
        try:
            for n in SWEEP_SPLITS:
                qmm.decode_split = _forced(n)
                c = qmm.prepare(name, x, qt.q, qt.scale, out_dtype=out_dtype)
                got = qmm.decode_split(K, N, group or K, 0)
                sweep.append(f"{got[0]}: {_timed2(c.launch, name, None)}")
        finally:
            qmm.decode_split = plan
        print("  splits, ms: " + ", ".join(sweep), flush=True)
        del qt, x, call, rows
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
