#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``finchat_tpu_torch``), one H100.

    python3 chip_smoke.py            # every phase, as the acceptance run does

Phases, in order; any failure exits non-zero and prints no result line:

1. Device and build: the card's name and power limit (``nvidia-smi``), then
   the CUDA kernels built from ``finchat_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (build seconds printed), and the registers, stack and spills
   of the Hopper kernels (``cuobjdump -res-usage``), the bf16 prefill body
   (``attention_bf16_sm90.cu``: its paged, ragged and contiguous entries),
   K7's Hopper backward (``flash_attention_bwd_sm90.cu``), the fused
   dequant matmul's decode body (``quant_matmul_decode_sm90.cu``) and the
   KV-row writer (``kv_write_sm90.cu``) among them; a Hopper attention
   kernel or a writer kernel that spills (stack or local memory) fails the
   run.
2. Kernels against their plain PyTorch versions on the card, at the serving
   shapes of Llama-3-8B (32 query heads, 8 KV heads, head_dim 128,
   page_size 128, 64 pages per sequence), over a bf16 cache and over an
   int8 cache with its scale planes: paged attention (decode B=64 C=1 over
   1-4k-token contexts and B=8 at the serve's 5,236 tokens; prefill B=4
   C=512 at q_offset 0 and 1024, and over the bf16 cache at the serve's
   q_offset 2048 and a lone 512-token chunk, B=1, at q_offset 0 and
   2048), the
   decode KV append (B=64 with invalid lanes; the int8 one quantizes) by
   name, beside it the KV-row writer that the engine writes every cache
   row through (``kv_write_sm90.cu``: ``kv_append_sm90``, and
   ``kv_append_q8_sm90`` quantizing; the decode step's 64 lanes, the 4 x 512
   chunk at q_offset 2048 and the serve-shaped round padded to its 2,048
   bucket, against the chunk scatter, every page bit-exact but the trash
   page where padding lanes share its rows, two launches identical), and
   ragged attention (two 512-token prefill rows, 60 decode rows, padding to
   a 2048 bucket; over the bf16 cache also a round shaped like the serve's,
   three 512-token rows at q_offset 1024, 2048 and 4096 beside 4 decode rows
   at 5,236 tokens). Decode goes to the Hopper decode body
   (``attention_decode_sm90.cu``) over both caches; the prefill chunks go to
   the Hopper prefill body of their cache (``attention_bf16_sm90.cu``,
   ``attention_q8_sm90.cu``); over the int8 cache the ragged round to the
   Hopper int8 body, over the bf16 cache to a pair of launches — the
   prefill tiles through the bf16 prefill body's ragged entry, the one-token
   rows through the decode body's — each entry held on its own rows and its
   launch timed alone against its own bound, plain version and SDPA calls,
   and the pair timed together; wherever the routing picks a Hopper body, the
   older body is held and timed beside it on the same inputs; every
   attention launch runs twice and must give identical outputs. Then the fused
   dequant matmul: the decode body (``quant_matmul_decode_sm90.cu``) at the
   decode step's M=64 on every llama3-8b layer weight shape — [4096, 4096]
   (q, o), [4096, 1024] (k, v), [4096, 14336] (gate, up), [14336, 4096]
   (down) — and on the [4096, 128256] head with fp32 output, and at the
   prefill chunk's M=4 head call; int4 at M=64 on [4096, 14336], per
   column and per group of 128; the Hopper kernel at prefill (M=2048 and
   the ragged round's M=1084, int8 on every weight shape and int4 per group
   of 128 on [4096, 14336]); v2 held and timed beside each on the same
   inputs, launched by its own name. The wrapper must launch the kernel its
   routing rule names, each kernel launches twice with identical outputs,
   and its time is that of one launch of 20 captured in a CUDA graph (the
   library call's likewise; no host work between launches, which would
   pace the small shapes), the routed wrapper's time beside it. Each case
   prints its max abs error; attention is held per
   output row (one token of one head) to min(2e-2, 2^-6 of the row's
   largest reference value), two bf16 ulps; a bf16 matmul output row to
   2^-7 of its largest value (one ulp: both sides round an fp32 sum of the
   same exact products); the fp32 head per element to K * 2^-22 * (|x| @
   |w|), a bound on two fp32 summations of K = 4096 products in any order;
   the appends bit-exact. Then it prints the kernel's and the plain
   version's median time per call over 20 CUDA-event-timed runs (each of
   back-to-back calls filling ~1 ms, at most 20; an attention kernel's
   launch is timed alone, its call's checks and tile descriptors built
   once, and the routed wrapper's time, host work included, beside it; the
   appends' launch and K7's backwards as one launch of 20 in a CUDA graph,
   their yardsticks likewise, the wrapper's time beside it; the writer, its
   plain version and its yardstick likewise),
   the bound (the
   larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s, counted from this
   run's inputs) and a library yardstick the port never calls:
   ``scaled_dot_product_attention`` over the pre-gathered (dequantized) KV
   on the same work, ``index_put_`` of the same rows for the bf16 append
   and the bf16 writer,
   ``torch.matmul`` with the already dequantized bf16 weight for the
   matmul (none for the quantizing append and writer: no one call quantizes
   and scatters). Last, contiguous flash attention (K7, the training path):
   the forward causal at B=1 S=2048 and with ``q_offset`` 1024 / ``kv_len``
   1536 at B=4 Sq=512, through the bf16 prefill body's contiguous entry
   (``flash_attention_sm90``, the kernel ``flash_kernel_for`` names) with the
   older forward (``flash_attention.cu``) by name beside it, each launched
   twice over an output and log-sum-exp filled with NaN (identical results),
   held per row as above plus the log-sum-exp (1e-3); and the backward at
   both cases, fed by the Hopper forward's out and log-sum-exp: the Hopper
   backward (``flash_attention_bwd_sm90``, the kernel
   ``flash_bwd_kernel_for`` names) with the older backward
   (``flash_attention.cu``) by name beside it, each launched twice over dq,
   dk and dv filled with NaN (identical results), each against the plain
   backward on the same inputs (per tensor ``||err|| / ||want|| <= 1e-2``,
   per row ``max|err| <= 2^-5 * max(row max, 2^-10 * tensor max)``: the
   kernels round dS to bf16 before their products) and against autograd of
   the plain ``mha_reference`` in fp32 on the same bf16 inputs (per tensor
   1e-2). Yardstick: ``scaled_dot_product_attention`` forward, and its
   backward through autograd, on the same work.
3. Serve: ``llama3-8b`` with random bf16 weights from a seeded generator,
   ``EngineConfig`` defaults minus the planes not ported yet, behind the
   scheduler, ``EngineGenerator`` and ``LLMService``. Four greedy requests
   at once, four more once the first tokens stream (so prefill coexists
   with decode and the packed ragged rounds run), 64 new tokens each. Every
   request must complete; every kernel of the plane must be launched in
   this phase (counts set to 0 just before it), the older paged body may
   not be launched at all (nor K3 on the bf16 plane, nor, on the quantized
   planes, K8's v2: every
   matmul of at most 64 rows, decode steps and heads, goes to the decode
   body), and the Hopper prefill body of the plane's
   cache must take every prefill chunk, one launch a layer; the KV-row
   writer of the plane's cache must take every cache write, one launch a
   layer of every decode step, prefill chunk and ragged round, and the
   older appends none; one served
   stream is then
   checked teacher-forced against the plain dense forward (same weights,
   plain attention). Last, one decode step, one prefill chunk and one
   serve-shaped ragged round at the served context length are timed and
   profiled (device time by kernel class, and the device's idle share of
   the profiled window).
4. Serve the quantized plane the same way: int8 weights made by
   ``init_quantized_params`` (the bf16 tree never exists) and an int8 KV
   pool, same 8 requests and two waves. The teacher-forced check runs the
   plain forward on the dequantized weights with every K/V row quantized
   and dequantized as the cache stores it; then the step profile.
5. Serve int4 weights (per group of 128) over the int8 KV pool: two
   requests, one after the other's first token, 16 new tokens each, with
   the same teacher-forced check — the path of the int4 matmul kernel.
6. Train: first ``llama3-8b`` widths at 2 layers, B=1, S=2048 — the loss,
   every leaf's gradient and the one-shot forward's logits through K7
   against the same step with the plain attention (relative per leaf and on
   the logits <= 5e-2, loss within 1e-2: both paths round every activation
   to bf16, and a one-ulp difference in an attention output spreads through
   the bf16 layers after it). Then the full model, 32 layers, random bf16
   weights: five AdamW steps (``train/train_step.py``, remat on) on one
   fixed batch of 2048 tokens. Every loss must be finite and the fifth
   below the first; in each step the Hopper forward must launch 64 times
   (each layer's forward, again in the backward under remat), the older
   forward never, the Hopper backward 32 times and the older backward
   never (counts set to 0 just before).
   Prints the step time, tokens/s, the
   model-FLOP share of the bf16 peak, the peak memory, and a sixth step's
   device time by class (profiler).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is visible or when the port package is not beside this file.
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# attention is held per output row (one token of one head, head_dim values):
# max|got - want| <= min(ATOL, REL_TOL * max|want|). Both sides round their
# output to bf16, one ulp apart at worst (2^-7 of the row's top binade), and
# round P to bf16 at different points of the fp32 softmax; REL_TOL is two
# ulps at the row's own scale, so a dropped key tile or a mis-weighted split
# shows at any context length, and ATOL caps rows of large values (a query
# with a handful of keys) at the former flat limit.
REL_TOL = 2.0 ** -6
ATOL = 2e-2
# fused dequant matmul: a bf16 output row within one ulp of its top binade;
# an fp32 output element within K * 2^-22 of the sum of |x| |w| products
QMM_ROW_TOL = 2.0 ** -7
QMM_F32_TOL = 2.0 ** -22
# the prefill cases of the fused dequant matmul: a 4 x 512 chunk and the
# ragged round of two 512-token rows and 60 decode rows, on every llama3-8b
# weight shape — q and o, k and v, gate and up, down ([K, N])
QMM_PREFILL_ROWS = (2048, 1084)
QMM_PREFILL_WEIGHTS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# the decode step's seven matmuls a layer at M=64, by their four shapes
QMM_DECODE_WEIGHTS = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
                      "down": (14336, 4096)}
# K7's backward against its plain version on the same inputs: the kernel
# rounds dS to bf16 (2^-9 relative) before its products, the plain version
# keeps it in fp32, and both round each gradient to bf16 (an emulation of
# those rounding points on the CPU, tests/test_torch_k7_rounding.py: 2.6e-3
# per tensor, a quarter of the row limit).
# The row floor is for rows whose gradient vanishes: the first query of a
# causal sequence sees one key, so its dS is zero up to fp32 cancellation.
GRAD_REL_TOL = 1e-2
GRAD_ROW_TOL = 2.0 ** -5
GRAD_ROW_FLOOR = 2.0 ** -10
# the training check, K7 against the plain attention through 2 full-width
# layers: every activation is bf16 on both paths, so a one-ulp difference in
# an attention output spreads through the layers after it (the emulation at
# dim 1024: 0.9-1.4e-2 per leaf, 1.0e-2 on the logits, 5e-5 on the loss)
TRAIN_REL_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-2
REPO = Path(__file__).resolve().parent
# the serving planes: the kernels each must launch, and its quant modes
# decode (C = 1 at page 128) goes to the Hopper decode body on every plane;
# prefill chunks (64-row blocks, page 128) to the Hopper prefill body of the
# cache — bf16 (attention_bf16_sm90.cu) or int8 — and the older paged body
# nothing; bf16 ragged rounds to the pair of Hopper ragged entries (the
# prefill tiles through the bf16 prefill body's, the one-token rows through
# the decode body's) and K3 nothing; K8: the Hopper kernel serves prefill
# (more than 64 rows), the decode body every call of at most 64 rows (decode
# steps, heads), v2 nothing; int8 attention: the Hopper int8 body also
# serves every ragged tile, and the older int8 ragged body nothing; every
# cache write (decode steps, chunks, rounds) goes to the KV-row writer of the
# cache, one launch a layer, and the older appends nothing
PLANES = {
    "bf16": dict(kernels=("paged_attention_sm90", "paged_attention_decode_sm90", "kv_append_sm90",
                          "ragged_paged_attention_sm90", "ragged_paged_attention_decode_sm90"),
                 never=("ragged_paged_attention", "kv_append"), quant="", group=0, kv_quant=""),
    "int8+kv8": dict(kernels=("paged_attention_q8_decode_sm90", "paged_attention_q8_sm90",
                              "kv_append_q8_sm90", "ragged_paged_attention_q8_sm90",
                              "quant_matmul_int8_sm90", "quant_matmul_int8_decode_sm90"),
                     never=("quant_matmul_int8", "kv_append_q8"), quant="int8", group=0,
                     kv_quant="int8"),
    "int4g128+kv8": dict(kernels=("paged_attention_q8_decode_sm90", "paged_attention_q8_sm90",
                                  "kv_append_q8_sm90", "ragged_paged_attention_q8_sm90",
                                  "quant_matmul_int4_sm90", "quant_matmul_int4_decode_sm90"),
                         never=("quant_matmul_int4", "kv_append_q8"), quant="int4", group=128,
                         kv_quant="int8"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log_resource_usage(lib: Path, kernel: str) -> bool:
    """Registers, stack (spills) and static shared memory of each
    instantiation of ``kernel`` in a built library, as ``cuobjdump
    -res-usage`` reports them. Returns whether one has a stack or local
    memory (a spill)."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        log(f"  {kernel}: resource usage not measured (no cuobjdump)")
        return False
    out = subprocess.run([str(tool), "-res-usage", str(lib)], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    spills = False
    for name, usage in zip(out, out[1:]):
        if kernel in name and "Function" in name:
            log(f"  {name.strip()[:100]}: {usage.strip()}")
            spills |= any(int(n) > 0 for n in re.findall(r"(?:STACK|LOCAL):(\d+)", usage))
    return spills


def _events_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` over ``iters``
    CUDA-event-timed runs. A run is as many back-to-back calls (at most 20)
    as fill about a millisecond, so the host's cost of a launch hides behind
    the card's work wherever the card takes longer than the host; a call of
    a millisecond or more runs alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reps = max(1, min(20, int(1.0 / max(_events_ms(torch, fn, 1), 0.05))))
    return statistics.median(_events_ms(torch, fn, reps) / reps for _ in range(iters))


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

H, HKV, D, PS, MP = 32, 8, 128, 128, 64  # llama3-8b heads, page_size, pages/seq
SERVE_CONTEXT = 5236  # the serves' longest prompt: the decode step's context in profile_steps
# a ragged round shaped like the serve's: three 512-token chunks at q_offset
# 1024, 2048 and 4096 beside 4 decode rows at SERVE_CONTEXT, in the 2048
# bucket of the 64-row round ((tokens, first position) per row)
SERVE_ROUND = [(512, 1024), (512, 2048), (512, 4096)] + [(1, SERVE_CONTEXT - 1)] * 4


def _cache(torch, gen, dev, n_layers: int, n_pages: int, q8: bool = False):
    """(k, v, k_scales, v_scales): random bf16 pages, or for ``q8`` the same
    random rows quantized as the int8 cache stores them (scales None for
    bf16)."""
    from finchat_tpu_torch.engine.kv_cache import quantize_kv_rows, scale_rows

    shape = (n_layers, n_pages, PS, HKV * D)
    out = []
    for _ in range(2):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        if not q8:
            out.append((x, None))
            continue
        q, s = quantize_kv_rows(x, HKV)  # s [L, P, PS, HKV]
        planes = torch.zeros((n_layers, n_pages, scale_rows(HKV), PS), device=dev)
        planes[:, :, :HKV] = s.transpose(2, 3)
        out.append((q, planes))
        del x
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _page_table(torch, gen, dev, kv_lens: list[int], n_pages: int):
    """Distinct physical pages per sequence (never the trash page 0)."""
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev).to(torch.int32) + 1
    pt = torch.zeros((len(kv_lens), MP), dtype=torch.int32, device=dev)
    nxt = 0
    for b, n in enumerate(kv_lens):
        k = max(1, -(-n // PS))
        pt[b, :k] = perm[nxt:nxt + k]
        nxt += k
    assert nxt < n_pages
    return pt


def _attention_flops(q_pos_kv: list[tuple[int, int]]) -> float:
    """QK and PV FLOPs for queries given as (position, kv_len) pairs."""
    keys = sum(min(p + 1, kl) for p, kl in q_pos_kv)
    return 4.0 * keys * H * D


def _kv_bytes(tokens: int, q8: bool) -> float:
    """Bytes of K and V for ``tokens`` cached tokens: bf16, or int8 plus
    one fp32 scale per token and KV head."""
    return tokens * HKV * (D + 4) * 2 if q8 else tokens * HKV * D * 2 * 2


def attention_errors(torch, got, want) -> tuple[float, float, bool]:
    """(max abs error, max over output rows of the row's max abs error over
    the row's largest reference value, every row within its limit); a row is
    one token of one head."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    ok = bool((diff <= (REL_TOL * scale).clamp(max=ATOL)).all().item())
    return diff.max().item(), (diff / scale.clamp(min=1e-30)).max().item(), ok


def _sdpa_ms(torch, calls) -> float:
    """scaled_dot_product_attention over pre-gathered KV: the summed time of
    ``calls``, each (q [B, H, Sq, D], k, v [B, Hkv, S, D], mask), timed
    together."""
    import torch.nn.functional as F

    def run():
        for q_rows, k_rows, v_rows, mask in calls:
            F.scaled_dot_product_attention(q_rows, k_rows, v_rows, attn_mask=mask,
                                           enable_gqa=True)

    return time_ms(torch, run)


def _gather_dense(torch, cache, pt, layer: int, S: int):
    """Dense bf16 [B, Hkv, S, D] K/V of each sequence's first S tokens
    (dequantized for an int8 cache)."""
    from finchat_tpu_torch.engine.kv_cache import gather_kv_any

    k, v = gather_kv_any(*cache, pt, PS, layer, HKV, dtype=torch.bfloat16)
    return (k[:, :S].permute(0, 2, 1, 3).contiguous(), v[:, :S].permute(0, 2, 1, 3).contiguous())


def check_attention_calls(torch, name: str, calls, want, live, results: list,
                          extra: dict, wrapper_ms: float) -> None:
    """Each prepared attention launch in ``calls`` (the routed kernel first,
    then the older body on the same inputs where the routing picked the
    Hopper one): launched twice (identical outputs), its live rows held
    against ``want``, its dead rows (no key, padding) zero, and its launch
    alone timed; ``wrapper_ms`` (the routed wrapper's time, its host work
    included) goes with the first."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES

    for n, call in enumerate(calls):
        before = dict(LAUNCHES)
        got = call.launch().clone()
        again = call.launch()
        torch.cuda.synchronize()
        moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
        if moved != {call.name: 2}:
            fail(f"{name}: expected two launches of {call.name}, launches moved: {moved}")
        same = bool(torch.equal(got, again))
        err, rel, close = attention_errors(torch, got[live], want[live])
        zeros_ok = bool((got[~live] == 0).all().item())
        finite = bool(torch.isfinite(got.float()).all().item())
        log(f"  {name} [{call.name}]: max_abs_err {err:.3e}, row-relative {rel:.3e} (limit per "
            f"row: min({ATOL}, {REL_TOL} * max|want|)), rows without keys zero: {zeros_ok}, "
            f"two launches identical: {same}")
        if not (close and zeros_ok and finite and same):
            fail(f"{name}: {call.name} disagrees with its plain version (row-relative {rel}, "
                 f"zeros {zeros_ok}, finite {finite}, identical {same})")
        del got, again
        ms = time_ms(torch, call.launch)
        routed = dict(wrapper_ms=wrapper_ms) if n == 0 and wrapper_ms is not None else {}
        log(f"  {name} [{call.name}]: kernel {ms:.4f} ms, plain {extra['plain_ms']:.4f} ms, "
            f"sdpa {extra['library_ms']:.4f} ms, bound {extra['bound_ms']:.4f} ms "
            f"({extra['bound_by']})" + (f"; the routed wrapper, its host work included, "
                                         f"{wrapper_ms:.4f} ms" if routed else ""))
        results.append(dict(case=name, kernel=call.name, err=err, rel_err=rel, ms=ms, **extra,
                            **routed))


def check_paged(torch, name, gen, dev, C: int, q_offsets: list[int], kv_lens: list[int],
                results: list, q8: bool = False) -> None:
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.paged_attention import (
        paged_attention_q8_ref,
        paged_attention_ref,
        paged_flash_attention,
        paged_flash_attention_q8,
        prepare_paged,
    )

    B, layer = len(kv_lens), 1
    n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
    k_pages, v_pages, k_scales, v_scales = cache = _cache(torch, gen, dev, 2, n_pages, q8)
    pt = _page_table(torch, gen, dev, kv_lens, n_pages)
    q = torch.randn((B, C, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
    q_off = torch.tensor(q_offsets, dtype=torch.int32, device=dev)
    kv = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    kw = dict(page_size=PS, n_kv=HKV)
    kind = "paged_attention_q8" if q8 else "paged_attention"
    scales = dict(k_scales=k_scales, v_scales=v_scales) if q8 else {}

    def wrapper():
        if q8:
            return paged_flash_attention_q8(q, k_pages, v_pages, k_scales, v_scales, pt, q_off,
                                            kv, layer, **kw)
        return paged_flash_attention(q, k_pages, v_pages, pt, q_off, kv, layer, **kw)

    def plain():
        if q8:
            return paged_attention_q8_ref(q, k_pages, v_pages, k_scales, v_scales, pt, q_off,
                                          kv, layer, **kw)
        return paged_attention_ref(q, k_pages, v_pages, pt, q_off, kv, layer, **kw)

    args = (q, k_pages, v_pages, pt, q_off, kv, layer)
    routed = prepare_paged(kind, *args, **kw, **scales)
    calls = [routed]
    if routed.name != kind:  # the older body on the same inputs, launched by name
        calls.append(prepare_paged(kind, *args, **kw, **scales, route=False))
    before = LAUNCHES[routed.name]
    wrapper()
    torch.cuda.synchronize()
    if LAUNCHES[routed.name] != before + 1:
        fail(f"{name}: the wrapper did not launch {routed.name}, the kernel its rule names")
    want = plain()
    S = max(kv_lens)
    k_rows, v_rows = _gather_dense(torch, cache, pt, layer, S)
    pos = torch.arange(S, device=dev)
    qp = q_off[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    mask = (pos[None, None, :] <= qp[:, :, None]) & (pos[None, None, :] < kv[:, None, None])
    lib_ms = _sdpa_ms(torch, [(q.transpose(1, 2).contiguous(), k_rows, v_rows, mask[:, None])])
    del k_rows, v_rows
    io_bytes = q.numel() * 2 * 2 + pt.numel() * 4 + B * 8
    flops = _attention_flops([(o + i, kl) for o, kl in zip(q_offsets, kv_lens) for i in range(C)])
    b_ms, b_by = bound_ms(_kv_bytes(sum(kv_lens), q8) + io_bytes, flops)
    extra = dict(plain_ms=time_ms(torch, plain), bound_ms=b_ms, bound_by=b_by,
                 library_ms=lib_ms)
    check_attention_calls(torch, name, calls, want, kv > 0, results, extra,
                          time_ms(torch, wrapper))
    del k_pages, v_pages, k_scales, v_scales, cache, calls, routed
    torch.cuda.empty_cache()


def _append_lanes(torch, gen, dev, B: int, P: int):
    """Page table, positions and validity of the append cases: positions
    inside each lane's first 8 pages; invalid lanes (every 8th) at distinct
    offsets so their trash-page writes never collide."""
    kv_lens = [int(x) for x in torch.randint(1, 4096, (B,), generator=gen, device=dev)]
    pt = torch.zeros((B, MP), dtype=torch.int32, device=dev)
    pt[:, :8] = (torch.arange(B * 8, device=dev, dtype=torch.int32).reshape(B, 8) % (P - 1)) + 1
    pos = torch.tensor([(n % (8 * PS)) if b % 8 else b for b, n in enumerate(kv_lens)],
                       dtype=torch.int32, device=dev)
    n_valid = torch.tensor([0 if b % 8 == 0 else 1 for b in range(B)], dtype=torch.int32,
                           device=dev)
    return pt, pos, n_valid


def check_append(torch, gen, dev, results: list) -> None:
    """K2 bit-exact against its plain version at the serving cache; its
    prepared launch timed alone, one launch of 20 in a CUDA graph (as the
    ``index_put_`` yardstick), the wrapper's time beside it."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.kv_append import (
        paged_kv_append,
        paged_kv_append_ref,
        prepare_append,
    )
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    B, L, P = 64, 32, 512  # the serving cache: [32, 512, 128, 1024]
    HD = HKV * D
    k_pages = torch.zeros((L, P, PS, HD), dtype=torch.bfloat16, device=dev)
    v_pages = torch.zeros_like(k_pages)
    pt, pos, n_valid = _append_lanes(torch, gen, dev, B, P)
    kv_new = torch.randn((B, 1, 2 * HD), generator=gen, device=dev, dtype=torch.bfloat16)
    layer = 17
    before = LAUNCHES["kv_append"]
    paged_kv_append(kv_new, k_pages, v_pages, pt, pos, n_valid, layer, page_size=PS)
    torch.cuda.synchronize()
    assert LAUNCHES["kv_append"] == before + 1
    k_ref, v_ref = torch.zeros_like(k_pages), torch.zeros_like(v_pages)
    paged_kv_append_ref(kv_new, k_ref, v_ref, pt, pos, n_valid, layer, page_size=PS)
    exact = bool(torch.equal(k_pages, k_ref) and torch.equal(v_pages, v_ref))
    err = max((k_pages.float() - k_ref.float()).abs().max().item(),
              (v_pages.float() - v_ref.float()).abs().max().item())
    log(f"  kv_append: bit-exact {exact} (max_abs_err {err:.3e})")
    if not exact:
        fail("kv_append: kernel is not bit-exact against its plain version")

    def wrapper():
        paged_kv_append(kv_new, k_pages, v_pages, pt, pos, n_valid, layer, page_size=PS)

    def plain():
        paged_kv_append_ref(kv_new, k_ref, v_ref, pt, pos, n_valid, layer, page_size=PS)

    # yardstick: index_put_ of the same rows at their (page, row) addresses
    phys = torch.where(n_valid > 0, pt.long().gather(1, (pos.long() // PS)[:, None])[:, 0], 0)
    off = pos.long() % PS
    k_rows, v_rows = kv_new[:, 0, :HD].contiguous(), kv_new[:, 0, HD:].contiguous()

    def library():
        k_ref[layer].index_put_((phys, off), k_rows)
        v_ref[layer].index_put_((phys, off), v_rows)

    ms = graph_ms(prepare_append(kv_new, k_pages, v_pages, pt, pos, n_valid, layer,
                                 page_size=PS).launch)
    wrapper_ms = time_ms(torch, wrapper)
    plain_ms = time_ms(torch, plain)
    lib_ms = graph_ms(library)
    moved = 2 * kv_new.numel() * 2 + B * (4 + 4 + 4)  # rows in, rows out, pos/valid/table
    b_ms, b_by = bound_ms(moved, 0.0)
    log(f"  kv_append: kernel {ms:.4f} ms (a launch of 20 in a CUDA graph; the wrapper, its "
        f"host work included, {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, index_put_ "
        f"{lib_ms:.4f} ms (graph), bound {b_ms:.6f} ms ({b_by})")
    results.append(dict(case="kv_append", kernel="kv_append", err=err, rel_err=None, ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        wrapper_ms=wrapper_ms))
    del k_pages, v_pages, k_ref, v_ref
    torch.cuda.empty_cache()


def check_append_q8(torch, gen, dev, results: list) -> None:
    """K5 bit-exact against its plain version at the serving int8 cache;
    timed as K2 is (no library call quantizes and scatters)."""
    from finchat_tpu_torch.engine.kv_cache import scale_rows
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.kv_append import (
        paged_kv_append_q8,
        paged_kv_append_q8_ref,
        prepare_append_q8,
    )
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    B, L, P = 64, 32, 512  # the serving int8 cache: [32, 512, 128, 1024] + scale planes
    HD = HKV * D
    k_pages = torch.zeros((L, P, PS, HD), dtype=torch.int8, device=dev)
    v_pages = torch.zeros_like(k_pages)
    k_scales = torch.zeros((L, P, scale_rows(HKV), PS), device=dev)
    v_scales = torch.zeros_like(k_scales)
    cache = (k_pages, v_pages, k_scales, v_scales)
    pt, pos, n_valid = _append_lanes(torch, gen, dev, B, P)
    kv_new = torch.randn((B, 1, 2 * HD), generator=gen, device=dev, dtype=torch.bfloat16)
    kv_new[5, 0, :D] = 0  # an all-zero head: scale 1/127
    layer = 17
    kw = dict(page_size=PS, n_kv=HKV)
    before = LAUNCHES["kv_append_q8"]
    paged_kv_append_q8(kv_new, *cache, pt, pos, n_valid, layer, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["kv_append_q8"] == before + 1
    ref = tuple(torch.zeros_like(t) for t in cache)
    paged_kv_append_q8_ref(kv_new, *ref, pt, pos, n_valid, layer, **kw)
    exact = all(bool(torch.equal(a, b)) for a, b in zip(cache, ref))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(cache, ref))
    log(f"  kv_append_q8: bit-exact {exact}, pages and scale planes (max_abs_err {err:.3e})")
    if not exact:
        fail("kv_append_q8: kernel is not bit-exact against its plain version")

    def wrapper():
        paged_kv_append_q8(kv_new, *cache, pt, pos, n_valid, layer, **kw)

    def plain():
        paged_kv_append_q8_ref(kv_new, *ref, pt, pos, n_valid, layer, **kw)

    ms = graph_ms(prepare_append_q8(kv_new, *cache, pt, pos, n_valid, layer, **kw).launch)
    wrapper_ms = time_ms(torch, wrapper)
    plain_ms = time_ms(torch, plain)
    # bf16 rows in, int8 rows and fp32 scales out, pos/valid/table entries
    moved = kv_new.numel() * 2 + kv_new.numel() + B * 2 * HKV * 4 + B * (4 + 4 + 4)
    b_ms, b_by = bound_ms(moved, 0.0)
    log(f"  kv_append_q8: kernel {ms:.4f} ms (a launch of 20 in a CUDA graph; the wrapper, its "
        f"host work included, {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, "
        f"bound {b_ms:.6f} ms ({b_by})")
    results.append(dict(case="kv_append_q8", kernel="kv_append_q8", err=err, rel_err=None,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        wrapper_ms=wrapper_ms))
    del cache, ref, k_pages, v_pages, k_scales, v_scales
    torch.cuda.empty_cache()


def _kv_write_cases(torch, gen, dev, n_pages: int):
    """The KV-row writer's cases at llama3-8b's KV width, as (name, plan, K,
    V, padding lanes share trash rows): a decode step of 64 lanes (the
    append cases' lanes, every 8th invalid at its own offset; K and V the
    halves of one fused row, each with a row stride of 2 * HD), the 4 x 512
    chunk at q_offset 2048, and the serve-shaped round (``SERVE_ROUND``:
    1,540 tokens padded to the 2,048 bucket of a 64-row round, the padding
    tokens all on the trash page's row 0)."""
    from finchat_tpu_torch.ops.kv_append import plan_kv_rows, plan_kv_rows_ragged

    HD = HKV * D
    i32 = dict(dtype=torch.int32, device=dev)
    bf = dict(generator=gen, device=dev, dtype=torch.bfloat16)
    pt, pos, n_valid = _append_lanes(torch, gen, dev, 64, n_pages)
    fused = torch.randn((64, 2 * HD), **bf)
    yield "decode", plan_kv_rows(pt, pos, n_valid, 1, PS), fused[:, :HD], fused[:, HD:], False
    pt = _page_table(torch, gen, dev, [2560] * 4, n_pages)
    plan = plan_kv_rows(pt, torch.full((4,), 2048, **i32), torch.full((4,), 512, **i32), 512, PS)
    k, v = torch.randn((2048, HD), **bf), torch.randn((2048, HD), **bf)
    yield "chunk_4x512_q2048", plan, k, v, False
    R, T = 64, 2048
    page_rows = torch.zeros((R, MP), **i32)
    page_rows[:len(SERVE_ROUND)] = _page_table(torch, gen, dev, [p0 + q for q, p0 in SERVE_ROUND],
                                               n_pages)
    tok_row = [r for r, (q, _p0) in enumerate(SERVE_ROUND) for _ in range(q)]
    tok_pos = [p0 + i for q, p0 in SERVE_ROUND for i in range(q)]
    pad = T - len(tok_row)
    plan = plan_kv_rows_ragged(page_rows, torch.tensor(tok_row + [R] * pad, **i32),
                               torch.tensor(tok_pos + [0] * pad, **i32), PS)
    k, v = torch.randn((T, HD), **bf), torch.randn((T, HD), **bf)
    yield "round_serve", plan, k, v, True


def check_kv_write(torch, dev, results: list, q8: bool) -> None:
    """The KV-row writer — K2 and K5 redesigned, every cache write of a
    serve — at the serving cache, per case of ``_kv_write_cases``: the
    wrapper launches its entry once, the cache is bit-exact against the
    plain version (the chunk scatter) on the same inputs (every layer and
    page; where padding lanes share trash rows, every page but the trash
    page 0), a second launch leaves it identical; the launch is timed as
    one of 20 in a CUDA graph, as are the plain version and, for the bf16
    cache, ``index_put_`` of the same rows, the routed wrapper's time (host
    work included) by events beside it. Its own generator: the draws of
    the cases after it stay as they were."""
    from finchat_tpu_torch.engine.kv_cache import scale_rows
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.kv_append import (
        paged_kv_write,
        paged_kv_write_ref,
        prepare_kv_write,
    )
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(2469 if q8 else 2468)
    L, P, HD, layer = 32, 512, HKV * D, 17  # the serving cache: [32, 512, 128, 1024]
    kernel = "kv_append_q8_sm90" if q8 else "kv_append_sm90"
    dtype = torch.int8 if q8 else torch.bfloat16

    def cache():
        pages = [torch.zeros((L, P, PS, HD), dtype=dtype, device=dev) for _ in range(2)]
        planes = [torch.zeros((L, P, scale_rows(HKV), PS), device=dev) for _ in range(2)] if q8 \
            else [None, None]
        return pages + planes

    got, ref = cache(), cache()
    label = "kv_write_q8" if q8 else "kv_write"
    for name, plan, k, v, collide in _kv_write_cases(torch, gen, dev, P):
        for t in got + ref:
            if t is not None:
                t.zero_()
        kw = dict(n_kv=HKV, k_scales=got[2], v_scales=got[3])
        kw_ref = dict(n_kv=HKV, k_scales=ref[2], v_scales=ref[3])
        before = dict(LAUNCHES)
        paged_kv_write(plan.rows, k, v, got[0], got[1], layer, **kw)
        torch.cuda.synchronize()
        moved = {n: LAUNCHES[n] - before[n] for n in LAUNCHES if LAUNCHES[n] != before[n]}
        if moved != {kernel: 1}:
            fail(f"{label}_{name}: expected one launch of {kernel}, launches moved: {moved}")
        paged_kv_write_ref(plan, k, v, ref[0], ref[1], layer, **kw_ref)
        live = slice(1, None) if collide else slice(None)
        pairs = [(a, b) for a, b in zip(got, ref) if a is not None]
        exact = all(bool(torch.equal(a[:, live], b[:, live])) for a, b in pairs)
        err = max((a[layer, live].float() - b[layer, live].float()).abs().max().item()
                  for a, b in pairs)
        first = [a[layer].clone() for a, _b in pairs]
        call = prepare_kv_write(plan.rows, k, v, got[0], got[1], layer, **kw)
        call.launch()
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a[layer, live], f[live]))
                   for (a, _b), f in zip(pairs, first))
        del first
        N = plan.rows.numel()
        log(f"  {label}_{name} [{kernel}]: {N} rows, bit-exact {exact} against the chunk "
            f"scatter (pages{' and scale planes' if q8 else ''}"
            f"{', every page but the trash page' if collide else ''}; max_abs_err {err:.3e}), "
            f"two launches identical: {same}")
        if not (exact and same):
            fail(f"{label}_{name}: {kernel} disagrees with its plain version "
                 f"(bit-exact {exact}, identical {same})")

        def wrapper():
            paged_kv_write(plan.rows, k, v, got[0], got[1], layer, **kw)

        def plain():
            paged_kv_write_ref(plan, k, v, ref[0], ref[1], layer, **kw_ref)

        ms = graph_ms(call.launch)
        wrapper_ms = time_ms(torch, wrapper)
        plain_ms = graph_ms(plain)
        lib_ms = None
        if not q8:  # yardstick: index_put_ of the same rows into each layer's [P * PS, HD] view
            rows_l = plan.rows.long()
            k_view, v_view = ref[0][layer].view(-1, HD), ref[1][layer].view(-1, HD)

            def library():
                k_view.index_put_((rows_l,), k)
                v_view.index_put_((rows_l,), v)

            lib_ms = graph_ms(library)
        # K and V rows in (bf16), written (bf16, or int8 and an fp32 scale a
        # head), and each token's row index
        out_bytes = 2 * HD + 2 * HKV * 4 if q8 else 2 * HD * 2
        b_ms, b_by = bound_ms(N * (2 * HD * 2 + out_bytes + 4), 0.0)
        log(f"  {label}_{name} [{kernel}]: kernel {ms:.4f} ms (a launch of 20 in a CUDA graph; "
            f"the wrapper, its host work included, {wrapper_ms:.4f} ms), plain {plain_ms:.4f} "
            f"ms (graph), " + (f"index_put_ {lib_ms:.4f} ms (graph)" if lib_ms is not None
                               else "library none") + f", bound {b_ms:.6f} ms ({b_by})")
        results.append(dict(case=f"{label}_{name}", kernel=kernel, err=err, rel_err=None, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                            wrapper_ms=wrapper_ms))
        del plan, k, v, call
    del got, ref
    torch.cuda.empty_cache()


def _ragged_sdpa_calls(torch, q, k_rows, v_rows, kv, spans, rows):
    """scaled_dot_product_attention's calls on the same work as ``rows`` of
    a ragged round (each 512 tokens long, or one token): the prefill rows as
    one call (B rows, Sq=512), the decode rows as another (Sq=1), each over
    its rows' KV padded to the longest of them and masked. Token offsets
    follow the packing (rows in order from token 0)."""
    starts = [sum(q_len for q_len, _p in spans[:r]) for r in range(len(spans))]
    pre = [r for r in rows if spans[r][0] > 1]
    dec = [r for r in rows if spans[r][0] == 1]
    dev = q.device
    calls = []
    if pre:
        s_pre = max(int(kv[r]) for r in pre)
        q_pre = torch.stack([q[starts[r]:starts[r] + 512] for r in pre]).transpose(1, 2)
        qpos = torch.tensor([[spans[r][1] + i for i in range(512)] for r in pre], device=dev)
        pos = torch.arange(s_pre, device=dev)
        idx = torch.tensor(pre, device=dev)
        mask = (pos[None, None, :] <= qpos[:, :, None]) & (pos[None, None, :] < kv[idx, None, None])
        calls.append((q_pre.contiguous(), k_rows[idx, :, :s_pre].contiguous(),
                      v_rows[idx, :, :s_pre].contiguous(), mask[:, None]))
    if dec:
        s_dec = max(int(kv[r]) for r in dec)
        idx = torch.tensor(dec, device=dev)
        q_dec = q[torch.tensor([starts[r] for r in dec], device=dev), :, None, :]
        mask = torch.arange(s_dec, device=dev)[None, None, None, :] < kv[idx, None, None, None]
        calls.append((q_dec.contiguous(), k_rows[idx, :, :s_dec].contiguous(),
                      v_rows[idx, :, :s_dec].contiguous(), mask))
    return calls


def _ragged_work(spans, kv_lens, rows, q8: bool, io: float):
    """(bound ms, bound by) of the work of ``rows`` of a round: their KV read
    once and ``io`` bytes of queries, outputs and descriptors; their
    tokens' causal FLOPs."""
    flops = _attention_flops([(p0 + i, kv_lens[r]) for r in rows
                              for q_len, p0 in [spans[r]] for i in range(q_len)])
    return bound_ms(_kv_bytes(sum(kv_lens[r] for r in rows), q8) + io, flops)


def check_ragged(torch, gen, dev, results: list, name: str, spans, T: int, R: int = 64,
                 q8: bool = False) -> None:
    """A ragged round (``spans``: (tokens, first position) per row, rows
    padded with empty ones to ``R``, tokens to ``T``) through the routed
    launches against the plain version; over the bf16 cache the pair of
    Hopper entries, each held on its own rows and timed alone, with the
    older body (K3) by name beside them on the same inputs."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES, PreparedSeq
    from finchat_tpu_torch.ops.ragged_paged_attention import (
        prepare_ragged,
        ragged_flash_attention,
        ragged_flash_attention_q8,
        ragged_paged_attention_ref,
    )

    kind = "ragged_paged_attention_q8" if q8 else "ragged_paged_attention"
    layer = 1
    spans = list(spans) + [(0, 0)] * (R - len(spans))
    kv_lens = [q_len + p0 for q_len, p0 in spans]
    n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
    k_pages, v_pages, k_scales, v_scales = cache = _cache(torch, gen, dev, 2, n_pages, q8)
    pt = _page_table(torch, gen, dev, kv_lens, n_pages)
    tok_row, tok_pos = [], []
    for r, (q_len, p0) in enumerate(spans):
        tok_row += [r] * q_len
        tok_pos += list(range(p0, p0 + q_len))
    n_real = len(tok_row)
    tok_row += [R] * (T - n_real)
    tok_pos += [0] * (T - n_real)
    tr = torch.tensor(tok_row, dtype=torch.int32, device=dev)
    tp = torch.tensor(tok_pos, dtype=torch.int32, device=dev)
    kv = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = torch.randn((T, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
    kw = dict(page_size=PS, n_kv=HKV)
    scales = dict(k_scales=k_scales, v_scales=v_scales) if q8 else {}

    def wrapper():
        if q8:
            return ragged_flash_attention_q8(q, k_pages, v_pages, k_scales, v_scales, pt, tr,
                                             tp, kv, layer, **kw)
        return ragged_flash_attention(q, k_pages, v_pages, pt, tr, tp, kv, layer, **kw)

    def plain(idx=None):
        """The plain version on every token, or on the tokens ``idx``."""
        qq, rr, pp = (q, tr, tp) if idx is None else (q[idx], tr[idx], tp[idx])
        return ragged_paged_attention_ref(qq, k_pages, v_pages, pt, rr, pp, kv, layer,
                                          k_scales=k_scales, v_scales=v_scales, **kw)

    args = (q, k_pages, v_pages, pt, tr, tp, kv, layer)
    routed = prepare_ragged(kind, *args, **kw, **scales)
    before = dict(LAUNCHES)
    wrapper()
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    if moved != {p.name: 1 for p in routed.parts}:
        fail(f"{name}: the wrapper launched {moved}, not the kernels its rule names "
             f"({routed.name})")
    want = plain()
    S = max(kv_lens)
    k_rows, v_rows = _gather_dense(torch, cache, pt, layer, S)
    live_rows = [r for r in range(R) if spans[r][0] > 0]
    lib_ms = _sdpa_ms(torch, _ragged_sdpa_calls(torch, q, k_rows, v_rows, kv, spans, live_rows))
    # q read and out written for every token of the bucket, the page table,
    # tok_row and tok_pos, kv_len
    io = q.numel() * 2 * 2 + pt.numel() * 4 + T * 8 + R * 4
    b_ms, b_by = _ragged_work(spans, kv_lens, live_rows, q8, io)
    plain_ms = time_ms(torch, plain, iters=3, warmup=1)
    extra = dict(plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    live = torch.arange(T, device=dev) < n_real
    wrapper_ms = time_ms(torch, wrapper)
    if isinstance(routed, PreparedSeq):
        check_ragged_pair(torch, name, routed, want, live, tr, spans, kv_lens, R, n_real, T,
                          (q, k_rows, v_rows, kv), plain, results, wrapper_ms, extra)
        calls = [prepare_ragged(kind, *args, **kw, **scales, route=False)]
        check_attention_calls(torch, name, calls, want, live, results, extra, None)
    else:
        calls = [routed]
        if routed.name != kind:  # the older body on the same inputs, launched by name
            calls.append(prepare_ragged(kind, *args, **kw, **scales, route=False))
        check_attention_calls(torch, name, calls, want, live, results, extra, wrapper_ms)
    del k_rows, v_rows, k_pages, v_pages, k_scales, v_scales, cache, calls, routed
    torch.cuda.empty_cache()


def check_ragged_pair(torch, name, pair, want, live, tr, spans, kv_lens, R: int, n_real: int,
                      T: int, dense, plain, results: list, wrapper_ms: float,
                      whole: dict) -> None:
    """A bf16 round's pair of launches (the prefill tiles, then the
    one-token rows, into one output): launched twice, identical; the
    round's live rows held against the plain version, padding zero; then
    each entry on the rows it writes — its error, its launch alone timed,
    its own bound, the plain version and SDPA on its rows — and the pair's
    time together."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES

    q, k_rows, v_rows, kv = dense
    before = dict(LAUNCHES)
    got = pair.launch().clone()
    again = pair.launch()
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    if moved != {p.name: 2 for p in pair.parts}:
        fail(f"{name}: expected two launches of each of {pair.name}, launches moved: {moved}")
    same = bool(torch.equal(got, again))
    err, rel, close = attention_errors(torch, got[live], want[live])
    zeros_ok = bool((got[~live] == 0).all().item())
    finite = bool(torch.isfinite(got.float()).all().item())
    log(f"  {name} [{pair.name}]: max_abs_err {err:.3e}, row-relative {rel:.3e} (limit per "
        f"row: min({ATOL}, {REL_TOL} * max|want|)), padding zero: {zeros_ok}, two launches "
        f"identical: {same}")
    if not (close and zeros_ok and finite and same):
        fail(f"{name}: {pair.name} disagrees with its plain version (row-relative {rel}, "
             f"zeros {zeros_ok}, finite {finite}, identical {same})")
    pair_ms = time_ms(torch, pair.launch)
    log(f"  {name} [{pair.name}]: the pair {pair_ms:.4f} ms (K3's bound {whole['bound_ms']:.4f} "
        f"ms, {whole['bound_by']}; sdpa {whole['library_ms']:.4f} ms); the routed wrapper, its "
        f"host work included, {wrapper_ms:.4f} ms")
    one = torch.tensor([q_len == 1 for q_len, _p in spans] + [False], device=got.device)
    dec_tok = one[tr.long().clamp(max=R)] & (tr < R)
    rows = {"ragged_paged_attention_sm90": [r for r in range(R) if spans[r][0] > 1],
            "ragged_paged_attention_decode_sm90": [r for r in range(R) if spans[r][0] == 1]}
    for part in pair.parts:
        decode = part.name.endswith("_decode_sm90")
        mine = dec_tok if decode else ~dec_tok  # the prefill entry also zeroes the padding
        idx = torch.nonzero(mine & live).flatten()
        p_err, p_rel, _ok = attention_errors(torch, got[idx], want[idx])
        ms = time_ms(torch, part.launch)
        p_plain = time_ms(torch, lambda: plain(idx), iters=3, warmup=1)
        lib = _sdpa_ms(torch, _ragged_sdpa_calls(torch, q, k_rows, v_rows, kv, spans,
                                                 rows[part.name]))
        # its tokens' q read and out written (the prefill entry also writes
        # the padding's zeros), its rows' page-table rows and descriptors
        n_tok, pad = int(idx.numel()), 0 if decode else T - n_real
        io = ((2 * n_tok + pad) * H * D * 2 + len(rows[part.name]) * (MP + 3) * 4
              + (n_tok + pad) * 8)
        b_ms, b_by = _ragged_work(spans, kv_lens, rows[part.name], False, io)
        log(f"  {name} [{part.name}]: its rows max_abs_err {p_err:.3e}, row-relative "
            f"{p_rel:.3e}; kernel {ms:.4f} ms alone, plain {p_plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        results.append(dict(case=name, kernel=part.name, err=p_err, rel_err=p_rel, ms=ms,
                            plain_ms=p_plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            pair_ms=pair_ms, wrapper_ms=wrapper_ms))


def check_qmm(torch, name: str, gen, dev, M: int, K: int, N: int, mode: str, group: int,
              out_f32: bool, results: list) -> None:
    """The fused dequant matmul against its plain version at one shape,
    through the wrapper (which must pick the kernel ``kernel_for`` names).
    Where that is a Hopper kernel, v2 is also held and timed on the same
    inputs, launched by its own name. Each kernel launches twice with
    identical outputs; the kernels' and the library call's times are those
    of one launch of 20 in a CUDA graph (``graph_ms``), the routed
    wrapper's (host work included) and the plain version's by CUDA events."""
    from finchat_tpu_torch.models.quant import dequantize, quantize, quantize_int4
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.quant_matmul import (
        kernel_for,
        prepare,
        quant_matmul_int4,
        quant_matmul_int8,
        quant_matmul_ref,
    )
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    w = torch.randn((K, N), generator=gen, device=dev, dtype=torch.bfloat16).mul_(K ** -0.5)
    qt = quantize_int4(w, group) if mode == "int4" else quantize(w)
    del w
    x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
    out_dtype = torch.float32 if out_f32 else None
    routed = kernel_for(mode, M, K, N, group or K, out_f32)
    fn = quant_matmul_int4 if mode == "int4" else quant_matmul_int8

    def plain():
        return quant_matmul_ref(x, qt, out_dtype=out_dtype)

    want = plain()
    w_deq = dequantize(qt, torch.bfloat16)
    if out_f32:
        limit = K * QMM_F32_TOL * (x.float().abs() @ w_deq.float().abs())
        how = f"per element {K} * 2^-22 * (|x| @ |w|)"
    else:
        limit = QMM_ROW_TOL * want.float().abs().amax(-1, keepdim=True)
        how = "per row 2^-7 * max|want row|"
    plain_ms = time_ms(torch, plain)
    if out_f32:
        lib_ms = graph_ms(lambda: torch.mm(x, w_deq, out_dtype=torch.float32))
    else:
        lib_ms = graph_ms(lambda: torch.matmul(x, w_deq))
    moved = (x.numel() * 2 + qt.q.numel() + qt.scale.numel() * 4
             + M * N * (4 if out_f32 else 2))
    b_ms, b_by = bound_ms(moved, 2.0 * M * K * N)
    plane = "int4g128+kv8" if mode == "int4" else "int8+kv8"
    v2 = f"quant_matmul_{mode}"
    for kname in (routed, v2) if routed != v2 else (routed,):
        if kname == routed:  # the wrapper launches what kernel_for names
            before = dict(LAUNCHES)
            fn(x, qt.q, qt.scale, out_dtype=out_dtype)
            torch.cuda.synchronize()
            moved_by = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
            if set(moved_by) != {kname}:
                fail(f"{name}: expected the wrapper to launch {kname}, launches moved: {moved_by}")
        call = prepare(kname, x, qt.q, qt.scale, out_dtype=out_dtype)
        outs = []
        for _ in range(2):
            before = dict(LAUNCHES)
            outs.append(call.launch().clone())
            torch.cuda.synchronize()
            if {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} != \
                    {kname: 1}:
                fail(f"{name}: a launch of {kname} was not counted once")
        got = outs[0]
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        finite = bool(torch.isfinite(got.float()).all().item())
        worst = (diff / limit.clamp(min=1e-30)).max().item()
        same = torch.equal(outs[0], outs[1])
        log(f"  {name} [{kname}]: max_abs_err {err:.3e}, worst error / limit {worst:.3f} "
            f"({how}), two launches identical: {same}")
        if not (worst <= 1.0 and finite and same):
            fail(f"{name}: {kname} disagrees with its plain version (error / limit {worst}) "
                 f"or with itself (identical: {same})")
        del got, diff, outs
        ms = graph_ms(call.launch)
        row = dict(case=name, kernel=kname, plane=plane, err=err, rel_err=worst, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        extra = ""
        if kname == routed:
            row["wrapper_ms"] = time_ms(torch, lambda: fn(x, qt.q, qt.scale, out_dtype=out_dtype))
            extra = f" (the routed wrapper, host work included: {row['wrapper_ms']:.4f} ms)"
        log(f"  {name} [{kname}]: kernel {ms:.4f} ms{extra}, plain {plain_ms:.4f} ms, "
            f"torch.{'mm' if out_f32 else 'matmul'} (bf16 weight) {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), share {b_ms / ms:.2f}")
        results.append(row)
        del call
    del qt, w_deq, x, want, limit
    torch.cuda.empty_cache()


def _causal_pairs(q_offsets: list[int], Sq: int, kv_lens: list[int]) -> int:
    """(query, key) pairs a causal attention with these descriptors needs."""
    return sum(min(o + i + 1, kl) for o, kl in zip(q_offsets, kv_lens) for i in range(Sq))


def grad_errors(torch, got, want) -> tuple[float, float, float]:
    """(max abs error, ||got - want|| / ||want||, worst per-row error over
    its limit 2^-5 * max(row max, 2^-10 * tensor max)); a row is one token
    of one head."""
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    diff = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1).clamp(min=GRAD_ROW_FLOOR * want.abs().max().item())
    return diff.max().item(), rel, (diff / (GRAD_ROW_TOL * scale).clamp(min=1e-30)).max().item()


def check_flash(torch, name, gen, dev, B: int, Sq: int, Sk: int, q_offsets: list[int],
                kv_lens: list[int], results: list, backward: bool = False) -> None:
    """K7 against its plain version at one causal shape: the forward (out
    and log-sum-exp) through the kernel ``flash_kernel_for`` names, and the
    older forward by name beside it where that is another; or with
    ``backward`` the backward ``flash_bwd_kernel_for`` names on the routed
    forward's out and lse, and the older backward by name beside it where
    that is another. Each forward launches twice over an output and lse
    filled with NaN, each backward over dq, dk and dv filled with NaN
    (identical results); a forward's prepared launch is timed alone, a
    backward's as one launch of 20 in a CUDA graph, the routed wrapper's
    time beside it."""
    import torch.nn.functional as F

    from finchat_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_fwd,
        flash_attention_ref,
        prepare_flash,
        prepare_flash_bwd,
    )
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.refs import mha_reference
    from finchat_tpu_torch.tools.qmm_decode_diag import graph_ms

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    q, k, v, dout = rnd(B, Sq, H, D), rnd(B, Sk, HKV, D), rnd(B, Sk, HKV, D), rnd(B, Sq, H, D)
    qo = torch.tensor(q_offsets, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    routed = prepare_flash(q, k, v, qo, kl, causal=True, scale=scale)
    before = LAUNCHES[routed.name]
    out, lse = flash_attention_fwd(q, k, v, qo, kl, causal=True, scale=scale)
    torch.cuda.synchronize()
    if LAUNCHES[routed.name] != before + 1:
        fail(f"{name}: the wrapper did not launch {routed.name}, the kernel its rule names")
    pairs = _causal_pairs(q_offsets, Sq, kv_lens)
    # SDPA's own causal mask is top-left aligned: give it the mask when the
    # queries sit at an offset
    pos = torch.arange(Sk, device=dev)
    qpos = qo[:, None] + torch.arange(Sq, device=dev)[None, :]
    mask = ((pos[None, None, :] <= qpos[:, :, None])
            & (pos[None, None, :] < kl[:, None, None]))[:, None]
    square = Sq == Sk and not any(q_offsets) and all(n == Sk for n in kv_lens)
    sdpa_kw = dict(is_causal=True) if square else dict(attn_mask=mask)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    io = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4 + B * 8
    if not backward:
        calls = [routed]
        if routed.name != "flash_attention":  # the older forward on the same inputs, by name
            calls.append(prepare_flash(q, k, v, qo, kl, causal=True, scale=scale,
                                       kernel="flash_attention"))

        def plain():
            return flash_attention_ref(q, k, v, q_offset=qo, kv_len=kl, causal=True)

        def library():
            F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)

        want, want_lse = plain()
        flops = 4.0 * pairs * H * D
        b_ms, b_by = bound_ms(io, flops)
        plain_ms = time_ms(torch, plain, iters=5, warmup=1)
        lib_ms = time_ms(torch, library)
        wrapper_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, qo, kl, causal=True,
                                                                scale=scale))
        for n, call in enumerate(calls):
            got = []
            for _ in range(2):
                call.out.fill_(float("nan"))
                call.aux.fill_(float("nan"))
                b4 = dict(LAUNCHES)
                got.append((call.launch().clone(), call.aux.clone()))
                torch.cuda.synchronize()
                if {kk: LAUNCHES[kk] - b4[kk] for kk in LAUNCHES if LAUNCHES[kk] != b4[kk]} != \
                        {call.name: 1}:
                    fail(f"{name}: a launch of {call.name} was not counted once")
            (o1, l1), (o2, l2) = got
            same = bool(torch.equal(o1, o2) and torch.equal(l1, l2))
            err, rel, close = attention_errors(torch, o1, want)
            lse_err = (l1 - want_lse).abs().max().item()
            finite = bool(torch.isfinite(o1.float()).all().item() and torch.isfinite(l1).all())
            log(f"  {name} [{call.name}]: max_abs_err {err:.3e}, row-relative {rel:.3e} (limit "
                f"per row: min({ATOL}, {REL_TOL} * max|want|)), lse max_abs_err {lse_err:.3e} "
                f"(limit 1e-3), two launches identical: {same}")
            if not (close and finite and lse_err <= 1e-3 and same):
                fail(f"{name}: {call.name} disagrees with its plain version (row-relative "
                     f"{rel}, lse {lse_err}, finite {finite}) or with itself ({same})")
            del got, o1, o2, l1, l2
            ms = time_ms(torch, call.launch)
            routed_ms = dict(wrapper_ms=wrapper_ms) if n == 0 else {}
            log(f"  {name} [{call.name}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share {b_ms / ms:.2f}"
                + (f"; the routed wrapper, its host work included, {wrapper_ms:.4f} ms"
                   if routed_ms else ""))
            results.append(dict(case=name, kernel=call.name, err=err, rel_err=rel, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib_ms, **routed_ms))
        torch.cuda.empty_cache()
        return
    log(f"  {name}: the backwards read the out and lse of {routed.name}")
    kw = dict(causal=True, scale=scale)

    def kern():
        return flash_attention_bwd(q, k, v, out, lse, dout, qo, kl, **kw)

    def plain():
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, q_offset=qo, kv_len=kl)

    calls = [prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, **kw)]
    if calls[0].name != "flash_attention_bwd":  # the older backward on the same inputs, by name
        calls.append(prepare_flash_bwd(q, k, v, out, lse, dout, qo, kl, **kw,
                                       kernel="flash_attention_bwd"))
    before = LAUNCHES[calls[0].name]
    kern()
    torch.cuda.synchronize()
    if LAUNCHES[calls[0].name] != before + 1:
        fail(f"{name}: the wrapper did not launch {calls[0].name}, the kernel its rule names")
    want = plain()
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    mha_reference(*leaves, causal=True, q_offset=qo, kv_len=kl).backward(dout.float())
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    do_lib = dout.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True, **sdpa_kw)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qg, kg, vg), do_lib)

    io += dout.numel() * 2 + (q.numel() + k.numel() + v.numel()) * 2  # dout in, grads out
    flops = 10.0 * pairs * H * D  # S again, dP, dV, dQ, dK: five products
    b_ms, b_by = bound_ms(io, flops)
    wrapper_ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, iters=5, warmup=1)
    # SDPA's backward alone: a graph of forward and backward less one of the
    # forward (autograd's backward is captured only with its forward)
    lib_ms = graph_ms(sdpa_fwd_bwd) - graph_ms(sdpa)
    for n, call in enumerate(calls):
        got = []
        for _ in range(2):
            grads = (call.out, *call.aux)
            for g in grads:
                g.fill_(float("nan"))
            b4 = dict(LAUNCHES)
            call.launch()
            torch.cuda.synchronize()
            if {kk: LAUNCHES[kk] - b4[kk] for kk in LAUNCHES if LAUNCHES[kk] != b4[kk]} != \
                    {call.name: 1}:
                fail(f"{name}: a launch of {call.name} was not counted once")
            got.append(tuple(g.clone() for g in grads))
        same = all(bool(torch.equal(a, b)) for a, b in zip(*got))
        err, worst = 0.0, 0.0
        for gname, g, w, w32 in zip(("dq", "dk", "dv"), got[0], want, leaves):
            e, r, row = grad_errors(torch, g, w)
            _e32, r32, _row32 = grad_errors(torch, g, w32.grad)
            finite = bool(torch.isfinite(g.float()).all().item())
            log(f"  {name} [{call.name}] {gname}: max_abs_err {e:.3e}, relative {r:.3e} (limit "
                f"{GRAD_REL_TOL}), worst row / limit {row:.3f}; against fp32 autograd of "
                f"mha_reference: relative {r32:.3e} (limit {GRAD_REL_TOL})")
            if not (r <= GRAD_REL_TOL and row <= 1.0 and r32 <= GRAD_REL_TOL and finite):
                fail(f"{name} {gname}: {call.name} disagrees with its plain backward")
            err, worst = max(err, e), max(worst, r)
        log(f"  {name} [{call.name}]: two launches identical: {same}")
        if not same:
            fail(f"{name}: two launches of {call.name} differ")
        del got
        ms = graph_ms(call.launch)  # one launch of 20 in a CUDA graph
        routed_ms = dict(wrapper_ms=wrapper_ms) if n == 0 else {}
        log(f"  {name} [{call.name}]: kernel {ms:.4f} ms (a launch of 20 in a CUDA graph"
            + (f"; the routed wrapper, its host work included, {wrapper_ms:.4f} ms"
               if routed_ms else "")
            + f"), plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms (graphs: forward and "
            f"backward less forward), bound {b_ms:.4f} ms ({b_by}), share {b_ms / ms:.2f}")
        results.append(dict(case=name, kernel=call.name, err=err, rel_err=worst, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                            **routed_ms))
    del leaves
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 3: serve
# --------------------------------------------------------------------------

CONTEXTS = [
    "Income: 6,200/month. Savings goal: emergency fund of 15,000.",
    "Recent transactions: groceries 142.10, rent 1,850.00, utilities 96.45. " * 6,
    "Accounts: checking 3,410; savings 8,900; 401k 41,250; credit card balance 1,240. " * 12,
    "Goal: pay off a 9,800 car loan at 6.9% APR within 18 months. " * 20,
    "User profile: 29 years old, salaried, contributes 6% to a 401k with 4% match. " * 4,
    "Spending last month: dining 410, travel 980, subscriptions 64, fuel 188. " * 10,
    "Debts: student loan 22,400 at 5.1%; no other debt. Risk appetite: moderate. " * 16,
    "Question context: considering a Roth IRA versus paying extra on the student loan. " * 8,
]


async def serve(torch, dev, plane: str, n_requests: int, max_new: int, profile: bool) -> dict:
    """Serve ``n_requests`` greedy requests through ``LLMService`` on one
    serving plane (``PLANES``): half at once, the rest once a first token
    streams. Launch counts are set to 0 just before and read just after."""
    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.llama import PRESETS, init_params, n_params
    from finchat_tpu_torch.models.quant import init_quantized_params
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS

    spec = PLANES[plane]
    config = PRESETS["llama3-8b"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    gc.collect()  # the previous plane's tree and cache are gone before this one's
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if spec["quant"]:
        params = init_quantized_params(config, gen, dev, mode=spec["quant"],
                                       group_size=spec["group"])
    else:
        params = init_params(config, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = (torch.cuda.memory_allocated() - base) / 1e9
    log(f"  llama3-8b: {config.n_layers} layers, {n_params(config) / 1e9:.2f} B params, "
        f"weights {weight_gb:.2f} GB on the card ({plane}), random init {init_s:.1f} s, "
        f"init peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above the "
        f"{base / 1e9:.2f} GB held before")
    ecfg = EngineConfig(prefix_cache=False, session_cache=False, preemption=False,
                        breaker_threshold=0, kv_quant=spec["kv_quant"])
    engine = InferenceEngine(config, params, ecfg, device=dev, quant=spec["quant"],
                             quant_group=spec["group"])
    chunk_calls = [0]  # prefill chunks: one launch of the Hopper prefill body a layer
    prefill_chunk = engine.prefill_chunk

    def counting_prefill_chunk(*a, **k):
        chunk_calls[0] += 1
        return prefill_chunk(*a, **k)

    engine.prefill_chunk = counting_prefill_chunk
    tok = ByteTokenizer()
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    handles = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    system_prompt = (REPO / "prompts" / "system_prompt.txt").read_text()
    svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                     SamplingParams(temperature=0.0, max_new_tokens=max_new))
    messages = [f"Request {i}: what should I do next with my money?" for i in range(8)]
    mixed0 = METRICS.get("finchat_mixed_dispatches_total")
    coexist0 = METRICS.get("finchat_coexist_iterations_total")
    decode0 = METRICS.get("finchat_decode_dispatches_total")
    reset_launches()
    await sched.start()

    async def one(i: int) -> str:
        text = []
        async for chunk in svc.process_message(messages[i], context=CONTEXTS[i]):
            text.append(chunk)
        return "".join(text)

    t_start = time.perf_counter()
    first = n_requests // 2
    wave1 = [asyncio.create_task(one(i)) for i in range(first)]
    while not any(h.generated > 0 for h in handles):
        await asyncio.sleep(0.005)
    wave2 = [asyncio.create_task(one(i)) for i in range(first, n_requests)]
    await asyncio.gather(*wave1, *wave2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    await sched.stop()
    launches = dict(LAUNCHES)
    prompt_lens = [len(h.prompt_ids) for h in handles]
    log(f"  served {len(handles)} requests in {wall:.2f} s; prompt tokens {prompt_lens}")
    log(f"  launches during serve: {launches}")
    if len(handles) != n_requests or not all(h.finished and h.generated > 0 for h in handles):
        fail(f"serve {plane}: not every request completed with tokens")
    if not all(h.generated == max_new or h.history[-1] == tok.eos_id for h in handles):
        fail(f"serve {plane}: a request ended before max_new_tokens without EOS")
    missing = [k for k in spec["kernels"] if launches[k] == 0]
    if missing:
        fail(f"serve {plane}: kernels not launched on the main path: {missing}")
    stray = {k: launches[k] for k in spec.get("never", ()) if launches[k]}
    if stray:
        fail(f"serve {plane}: calls reached kernels the routing keeps off this path: {stray}")
    del engine.prefill_chunk
    older = "paged_attention_q8" if spec["kv_quant"] else "paged_attention"
    want_chunks = chunk_calls[0] * config.n_layers
    log(f"  prefill chunks {chunk_calls[0]}: {launches[older + '_sm90']} launches of the "
        f"Hopper prefill body (want {want_chunks}), {launches[older]} of the older paged body")
    if launches[older] != 0:
        fail(f"serve {plane}: {launches[older]} calls reached the older paged body")
    if launches[older + "_sm90"] != want_chunks:
        fail(f"serve {plane}: the Hopper prefill body took {launches[older + '_sm90']} "
             f"calls, not one a layer of each of {chunk_calls[0]} prefill chunks")
    if sched.allocator.used_count != 0:
        fail(f"serve {plane}: {sched.allocator.used_count} KV pages still allocated")
    if sched.quant_label != plane.replace("g128", ""):
        fail(f"serve {plane}: the scheduler reports quant label {sched.quant_label}")
    ttfts = sorted(h.first_token_at - h.submitted_at for h in handles)
    ttft_p50 = statistics.median(ttfts)
    decode_tokens = sum(h.generated - 1 for h in handles)
    t_first = min(h.first_token_at for h in handles)
    t_last = max(h.last_token_at for h in handles)
    agg_tps = decode_tokens / max(t_last - t_first, 1e-9)
    per_stream = statistics.median(
        (h.generated - 1) / max(h.last_token_at - h.first_token_at, 1e-9) for h in handles)
    mixed = METRICS.get("finchat_mixed_dispatches_total") - mixed0
    coexist = METRICS.get("finchat_coexist_iterations_total") - coexist0
    log(f"  ragged rounds {mixed:.0f}, coexist iterations {coexist:.0f}; gauges: "
        f"weight bits {METRICS.get('finchat_quant_weight_bits'):.0f}, "
        f"KV bits {METRICS.get('finchat_quant_kv_bits'):.0f}")
    if mixed < 1:
        fail(f"serve {plane}: no packed ragged round ran (prefill never coexisted with decode)")
    # every cache write: one launch of the writer a layer of each decode
    # step, prefill chunk and ragged round
    decode_steps = METRICS.get("finchat_decode_dispatches_total") - decode0
    writer, older_append = (("kv_append_q8_sm90", "kv_append_q8") if spec["kv_quant"]
                            else ("kv_append_sm90", "kv_append"))
    want_writes = int(config.n_layers * (decode_steps + chunk_calls[0] + mixed))
    log(f"  KV writes: {launches[writer]} launches of {writer} (want {want_writes} = "
        f"{config.n_layers} x ({decode_steps:.0f} decode steps + {chunk_calls[0]} chunks + "
        f"{mixed:.0f} rounds)), {launches[older_append]} of the older append")
    if launches[writer] != want_writes:
        fail(f"serve {plane}: the KV-row writer took {launches[writer]} layer writes, not one a "
             f"layer of every step ({want_writes})")
    check = teacher_forced_check(torch, params, config, handles, spec["kv_quant"])
    steps = (profile_steps(torch, engine, context=max(prompt_lens), active=len(handles))
             if profile else None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sched.submit = submit  # break the wrapper's cycle so the tree can go
    del engine, sched, svc, params, recording_submit, submit
    gc.collect()
    torch.cuda.empty_cache()
    return dict(plane=plane, ttft_p50_s=ttft_p50, ttft_s=ttfts, decode_tokens_per_s=agg_tps,
                decode_tokens_per_s_per_stream=per_stream, wall_s=wall,
                prompt_tokens=prompt_lens, launches=launches, ragged_rounds=mixed,
                weight_gb=weight_gb, peak_gb=peak_gb, teacher_forced=check, steps=steps)


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "attention_decode_sm90" in n:
        return ("attention ragged decode sm90 (ours)" if "raggedrows" in n
                else "attention decode sm90 (ours)")
    if "ragged_attention_bf16_sm90" in n:
        return "attention ragged sm90 (ours)"
    if any(k in n for k in ("paged_attention_kernel", "ragged_attention_kernel",
                            "attention_q8_sm90_kernel", "attention_bf16_sm90_kernel",
                            "combine_splits")):
        return "attention (ours)"
    if "kv_write" in n:
        return "kv_append sm90 (ours)"
    if "kv_append" in n:
        return "kv_append (ours)"
    if "quant_matmul_decode" in n:
        return "quant_matmul decode sm90 (ours)"
    if "quant_matmul_sm90_kernel" in n:
        return "quant_matmul sm90 (ours)"
    if "quant_matmul_kernel" in n:
        return "quant_matmul v2 (ours)"
    if any(k in n for k in ("gemm", "gemv", "xmma", "cutlass", "sm90", "nvjet", "matmul")):
        return "matmul (cuBLAS)"
    return "other"


def device_ms(torch, prof, classify, runs: int = 1, top: int = 4) -> tuple[dict, dict]:
    """Device milliseconds per run by kernel class from a profile, and the
    ``top`` largest kernels of the class "other"."""
    by_class: dict[str, float] = {}
    others: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops also carry their kernels' device time
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us:
            cls = classify(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3 / runs
            if cls == "other":  # names cut to 90 characters: sum what they merge
                key = ev.key[:90]
                others[key] = others.get(key, 0.0) + dev_us / 1e3 / runs
    return by_class, dict(sorted(others.items(), key=lambda x: -x[1])[:top])


def profile_steps(torch, engine, context: int, active: int) -> dict:
    """Where a step's time goes, after serving: a decode step with ``active``
    slots at ``context`` tokens, a 4 x 512 prefill chunk at q_offset 2048,
    and a ragged round shaped like the serve's (``SERVE_ROUND``: three
    512-token chunks at q_offset 1024, 2048 and 4096 beside 4 decode rows at
    ``context``, their positions given by the host), each timed with CUDA
    events around whole steps (host enqueue included) and profiled with
    torch.profiler for device time by kernel class. The idle share is 1 -
    device busy / window, both taken in the same profiled window: CUDA events recorded inside the profile around
    its steps (the profiler's own host cost is in that window, so the share
    reads high against an unprofiled step). Uses the engine's own state
    (random KV), slots 0..active-1."""
    from torch.profiler import ProfilerActivity, profile

    B = engine.engine_cfg.max_seqs
    per = -(-(context + 8) // engine.page_size)
    engine.set_page_table_rows({s: list(range(1 + s * per, 1 + (s + 1) * per))
                                for s in range(active)})
    engine.set_context_lens_rows({s: context for s in range(active)})
    act = [s < active for s in range(B)]
    zeros, ones, izeros = [0.0] * B, [1.0] * B, [0] * B
    prefill_args = ([[7] * 512] * 4, [0, 1, 2, 3], [2048] * 4, [512] * 4)

    def decode():
        engine.decode(act, zeros, ones, izeros)

    def prefill():
        engine.prefill_chunk(*prefill_args)

    # the round's rows on slots 0..6, every row's first position from the
    # host (so repeated rounds see the same positions), nothing committed
    R = B
    chunks = [(min(p0, context - q_len), q_len) for q_len, p0 in SERVE_ROUND if q_len > 1]
    spans = chunks + [(context - 1, 1)] * sum(q_len == 1 for q_len, _p in SERVE_ROUND)
    tok_row = [r for r, (_p, q_len) in enumerate(spans) for _ in range(q_len)]
    T = engine.ragged_bucket(len(tok_row))
    pad = [0] * (R - len(spans))
    ragged_args = ([7] * T, tok_row + [R] * (T - len(tok_row)), list(range(len(spans))) + pad,
                   [p for p, _q in spans] + pad, [q_len for _p, q_len in spans] + pad,
                   [False] * R, [False] * R, zeros, ones, izeros)

    def ragged():
        engine.ragged_mixed(*ragged_args)

    out = {}
    for name, fn in (("decode_step", decode), ("prefill_chunk_4x512", prefill),
                     ("ragged_round_serve", ragged)):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        w_start = torch.cuda.Event(enable_timing=True)
        w_end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w_start.record()
            for _ in range(3):
                fn()
            w_end.record()
            torch.cuda.synchronize()
        window_ms = w_start.elapsed_time(w_end) / 3
        by_class, top_other = device_ms(torch, prof, _kernel_class, runs=3)
        ev_ms = time_ms(torch, fn, iters=5, warmup=1)
        busy = sum(by_class.values())
        out[name] = dict(event_ms=ev_ms, profiled_window_ms=window_ms, device_busy_ms=busy,
                         idle_share=1.0 - busy / window_ms,
                         device_ms_by_class=by_class, top_other=top_other)
        log(f"  {name}: {ev_ms:.2f} ms per step (CUDA events); profiled {window_ms:.2f} ms "
            f"per step, device busy {busy:.2f} ms (idle share {1.0 - busy / window_ms:.3f}): "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_class.items(), key=lambda x: -x[1])))
    engine.reset_slots(list(range(active)))
    return out


class _Dequantized:
    """A stacked quantized leaf read one layer at a time as its dequantized
    bf16 weight (``leaf[i]``, how the forward slices a layer), so the plain
    forward never holds the whole bf16 tree."""

    def __init__(self, leaf):
        self.leaf = leaf

    def __getitem__(self, i):
        from finchat_tpu_torch.models.quant import dequantize

        return dequantize(self.leaf[i])


def teacher_forced_check(torch, params, config, handles, kv_quant: str) -> dict:
    """Re-run the shortest served stream through the plain dense forward
    (no cache, plain attention, plain matmuls) and require the served greedy
    token wherever the plain forward's top-2 logit margin exceeds 0.25 —
    bf16 activations through 32 layers move logits by a few hundredths, so
    a larger margin cannot flip. A quantized tree runs on its dequantized
    weights; an int8 KV cache is mirrored by quantizing and dequantizing
    every K/V row (``quantize_kv_rows``) before attention, so both sides see
    the same values."""
    from finchat_tpu_torch.engine.kv_cache import quantize_kv_rows
    from finchat_tpu_torch.models.llama import dense_causal_attention, forward
    from finchat_tpu_torch.models.quant import Q4Tensor, QTensor, dequantize
    from finchat_tpu_torch.ops.refs import mha_reference

    def plain_leaf(leaf):
        return _Dequantized(leaf) if isinstance(leaf, (QTensor, Q4Tensor)) else leaf

    plain = {**params, "layers": {n: plain_leaf(v) for n, v in params["layers"].items()}}
    if isinstance(params.get("lm_head"), (QTensor, Q4Tensor)):
        plain["lm_head"] = dequantize(params["lm_head"])

    def kv_roundtrip(x):  # [B, S, Hkv, hd]
        B, S, n_kv, hd = x.shape
        q8, sc = quantize_kv_rows(x.reshape(B, S, n_kv * hd), n_kv)
        return (q8.reshape(B, S, n_kv, hd).float() * sc[..., None]).to(x.dtype)

    def q8_attention(q, k, v, cache, layer_idx):
        return mha_reference(q, kv_roundtrip(k), kv_roundtrip(v), causal=True), cache

    h = min(handles, key=lambda x: len(x.prompt_ids))
    ids = h.history[:-1]
    n_prompt = len(h.prompt_ids)
    dev = params["embed"].device
    tokens = torch.tensor([ids], dtype=torch.int64, device=dev)
    positions = torch.arange(len(ids), device=dev)[None]
    attention = q8_attention if kv_quant else dense_causal_attention
    with torch.no_grad():
        logits, _ = forward(plain, tokens, positions, config=config, attention=attention)
        logits = logits[0, n_prompt - 1:]
    if not bool(torch.isfinite(logits).all().item()):
        fail("teacher-forced check: non-finite logits from the plain forward")
    top2 = torch.topk(logits, 2, dim=-1)
    margin = (top2.values[:, 0] - top2.values[:, 1]).cpu()
    want = top2.indices[:, 0].cpu()
    served = torch.tensor(h.history[n_prompt:], dtype=torch.int64)
    n = min(len(served), len(want))
    decided = margin[:n] > 0.25
    agree = (want[:n] == served[:n])
    bad = int((decided & ~agree).sum())
    log(f"  teacher-forced: {int(agree.sum())}/{n} served tokens equal the plain forward's "
        f"argmax; {int(decided.sum())} have margin > 0.25, {bad} of those disagree")
    if bad:
        fail("teacher-forced check: served tokens disagree with the plain forward")
    del plain, logits
    return dict(tokens=n, agree=int(agree.sum()), decided=int(decided.sum()))


# --------------------------------------------------------------------------
# phase 6: train
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 1, 2048
# K7's kernels, counted in the train phase: the Hopper forward (the bf16
# prefill body's contiguous entry), the older forward, the older backward,
# the Hopper backward
K7_KERNELS = ("flash_attention_sm90", "flash_attention", "flash_attention_bwd",
              "flash_attention_bwd_sm90")


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_check(torch, dev) -> dict:
    """``llama3-8b`` widths at 2 layers: loss, every leaf's gradient and the
    one-shot forward's logits through K7 against the plain attention."""
    import dataclasses

    from finchat_tpu_torch.models.llama import (
        PRESETS,
        dense_causal_attention,
        forward,
        forward_full,
        init_params,
    )
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.train.train_step import named_leaves, value_and_grad

    _free(torch)
    config = dataclasses.replace(PRESETS["llama3-8b"], n_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    params = init_params(config, gen, dev)
    tokens = torch.randint(0, config.vocab_size, (TRAIN_B, TRAIN_S), generator=gen, device=dev)
    reset_launches()
    loss_k, grads_k = value_and_grad(params, tokens, config=config)
    torch.cuda.synchronize()
    # (Hopper forward, older forward, older backward, Hopper backward): the
    # training shape's forward is the bf16 prefill body's contiguous entry,
    # its backward flash_attention_bwd_sm90
    launches = tuple(LAUNCHES[k] for k in K7_KERNELS)
    loss_p, grads_p = value_and_grad(params, tokens, config=config,
                                     attention=dense_causal_attention)
    plain = dict(named_leaves(grads_p))
    worst_leaf, worst = "", 0.0
    for path, g in named_leaves(grads_k):
        want = plain[path].float()
        rel = ((g.float() - want).norm() / want.norm().clamp(min=1e-30)).item()
        if rel >= worst:
            worst_leaf, worst = path, rel
    loss_diff = abs(loss_k.item() - loss_p.item())
    del grads_k, grads_p, plain
    for _path, leaf in named_leaves(params):
        leaf.requires_grad_(False)
    positions = torch.arange(TRAIN_S, device=dev).expand(TRAIN_B, TRAIN_S)
    with torch.no_grad():
        got = forward_full(params, tokens, positions, config=config)
        want, _ = forward(params, tokens, positions, config=config,
                          attention=dense_causal_attention)
        logit_rel = ((got - want).norm() / want.norm()).item()
        finite = bool(torch.isfinite(got).all().item())
    log(f"  2 layers at llama3-8b widths, B={TRAIN_B} S={TRAIN_S}: loss K7 {loss_k.item():.6f}, "
        f"plain {loss_p.item():.6f} (|diff| {loss_diff:.3e}, limit {TRAIN_LOSS_TOL}); worst "
        f"leaf gradient {worst_leaf} relative {worst:.3e}; one-shot forward logits relative "
        f"{logit_rel:.3e} (limits {TRAIN_REL_TOL}); K7 launches (Hopper forward, older "
        f"forward, older backward, Hopper backward) {launches}")
    if not (loss_diff <= TRAIN_LOSS_TOL and worst <= TRAIN_REL_TOL
            and logit_rel <= TRAIN_REL_TOL and finite and launches[0] > 0 and launches[1] == 0
            and launches[2] == 0 and launches[3] > 0):
        fail("train check: the K7 path disagrees with the plain attention")
    del params, got, want
    _free(torch)
    return dict(loss_k7=loss_k.item(), loss_plain=loss_p.item(), worst_leaf=worst_leaf,
                worst_leaf_rel=worst, logits_rel=logit_rel, launches=launches)


def _train_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n or "flash_attention_bf16_sm90" in n:
        return "K7 forward"
    if "flash_bwd" in n:  # flash_attention.cu's three kernels and the Hopper backward's
        return "K7 backward"
    if "adam" in n:
        return "optimizer"
    return "cuBLAS" if _kernel_class(name) == "matmul (cuBLAS)" else "other"


def train_full(torch, dev, card: str, steps: int = 5) -> dict:
    """Five AdamW steps of the full ``llama3-8b`` on one fixed batch, then a
    profiled sixth. Launch counts are set to 0 just before the five steps
    and read just after."""
    from torch.profiler import ProfilerActivity, profile

    from finchat_tpu_torch.models.llama import PRESETS, init_params, n_params
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.train.train_step import init_train_state, make_optimizer, make_train_step

    _free(torch)
    config = PRESETS["llama3-8b"]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(config, gen, dev)
    tokens = torch.randint(0, config.vocab_size, (TRAIN_B, TRAIN_S), generator=gen, device=dev)
    optimizer = make_optimizer()
    state = init_train_state(config, params, optimizer)
    train_step = make_train_step(config, optimizer)
    losses, times, per_step = [], [], []
    reset_launches()
    for _ in range(steps):
        before = [LAUNCHES[k] for k in K7_KERNELS]
        t0 = time.perf_counter()
        state, loss = train_step(state, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        per_step.append(tuple(LAUNCHES[k] - n for k, n in zip(K7_KERNELS, before)))
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  llama3-8b, {config.n_layers} layers, {n_params(config) / 1e9:.2f} B params, "
        f"B={TRAIN_B} S={TRAIN_S}, remat on: losses {losses}; step seconds "
        f"{[round(t, 4) for t in times]}; K7 launches per step (Hopper forward, older forward, "
        f"older backward, Hopper backward) {per_step}")
    L = config.n_layers
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train: losses not finite and falling: {losses}")
    # remat: each layer's forward runs twice a step (again in the backward)
    if not all(step == (2 * L, 0, 0, L) for step in per_step):
        fail(f"train: K7's Hopper forward did not take every layer's forward twice a step "
             f"({2 * L}), with none of the older forward, and the Hopper backward every "
             f"layer's backward once ({L}), with none of the older backward: {per_step}")

    step_s = statistics.median(times[1:])  # step 1 also allocates moments and grads
    T = TRAIN_B * TRAIN_S
    n_matmul = n_params(config) - config.vocab_size * config.dim  # the embedding is a lookup
    pairs = TRAIN_B * TRAIN_S * (TRAIN_S + 1) // 2
    attn_flops = 3 * 4.0 * pairs * config.n_heads * config.head_dim * L  # forward + backward
    model_flops = 6.0 * n_matmul * T + attn_flops
    mfu = model_flops / step_s / BF16_FLOPS_PER_S

    w_start = torch.cuda.Event(enable_timing=True)
    w_end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w_start.record()
        state, loss = train_step(state, tokens)
        w_end.record()
        torch.cuda.synchronize()
    window_ms = w_start.elapsed_time(w_end)
    by_class, top_other = device_ms(torch, prof, _train_class, top=6)
    busy = sum(by_class.values())
    log(f"  train step: {step_s * 1e3:.1f} ms (median of steps 2-{steps}), "
        f"{T / step_s:.1f} tokens/s, model-FLOP share {mfu:.3f} of 989 TFLOP/s "
        f"(6 N T + attention, N = {n_matmul / 1e9:.2f} B matmul params), peak memory "
        f"{peak_gb:.2f} GB ({card})")
    log(f"  profiled step: window {window_ms:.1f} ms, device busy {busy:.1f} ms (idle share "
        f"{1.0 - busy / window_ms:.3f}): "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(by_class.items(), key=lambda x: -x[1]))
        + f" ({card})")
    log("  largest 'other' kernels (ms): "
        + "; ".join(f"{k} {v:.1f}" for k, v in top_other.items()))
    del state, params, prof
    _free(torch)
    return dict(losses=losses, step_s=times, median_step_s=step_s, tokens_per_s=T / step_s,
                model_flop_share=mfu, peak_gb=peak_gb, launches=launches,
                launches_per_step=per_step, profiled_window_ms=window_ms,
                device_busy_ms=busy, device_ms_by_class=by_class, top_other=top_other)


# --------------------------------------------------------------------------


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device is visible (torch.cuda.is_available() is false)", 2)
    if not (REPO / "finchat_tpu_torch" / "csrc").is_dir():
        fail(f"the port package finchat_tpu_torch is not beside {Path(__file__).name}", 3)
    sys.path.insert(0, str(REPO))
    from finchat_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else "unknown"
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: device {kind} ({card}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_s = kernels.build_all()
    log(f"  kernels built in {build_s:.1f} s from {kernels.CSRC}")
    log_resource_usage(kernels.library_path("quant_matmul_sm90.cu"), "quant_matmul_sm90_kernel")
    log_resource_usage(kernels.library_path("quant_matmul_decode_sm90.cu"), "quant_matmul_decode")
    log_resource_usage(kernels.library_path("attention_q8_sm90.cu"), "attention_q8_sm90_kernel")
    # the bf16 prefill body's paged, ragged and contiguous entries, the
    # decode body's instantiations (paged bf16 and int8, ragged bf16) and
    # their merges, K7's Hopper backward (pre-pass, dK/dV and dQ bodies),
    # the KV-row writer's two kernels
    spills = [src for src, kernel in (("attention_bf16_sm90.cu", "attention_bf16_sm90_kernel"),
                                      ("attention_decode_sm90.cu", "attention_decode_sm90"),
                                      ("flash_attention_bwd_sm90.cu", "flash_bwd_"),
                                      ("kv_write_sm90.cu", "kv_write_"))
              if log_resource_usage(kernels.library_path(src), kernel)]
    if spills:
        fail(f"the Hopper kernels of {spills} spill to local memory")

    log("phase 2: kernels against their plain versions (llama3-8b shapes)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results: list[dict] = []
    dec_lens = [int(x) for x in torch.randint(1, 4097, (64,), generator=gen, device=dev)]
    serve_lens = [SERVE_CONTEXT] * 8
    check_paged(torch, "paged_decode", gen, dev, 1, [n - 1 for n in dec_lens], dec_lens, results)
    check_paged(torch, "paged_decode_b8", gen, dev, 1, [n - 1 for n in serve_lens], serve_lens,
                results)
    check_paged(torch, "paged_prefill_q0", gen, dev, 512, [0] * 4, [512] * 4, results)
    check_paged(torch, "paged_prefill_q1024", gen, dev, 512, [1024] * 4, [1536] * 4, results)
    check_paged(torch, "paged_prefill_q2048", gen, dev, 512, [2048] * 4, [2560] * 4, results)
    check_paged(torch, "paged_prefill_b1_q0", gen, dev, 512, [0], [512], results)
    check_paged(torch, "paged_prefill_b1_q2048", gen, dev, 512, [2048], [2560], results)
    check_append(torch, gen, dev, results)
    check_kv_write(torch, dev, results, q8=False)
    dec = [int(x) for x in torch.randint(1, 4096, (60,), generator=gen, device=dev)]
    check_ragged(torch, gen, dev, results, "ragged",
                 [(512, 0), (512, 1024)] + [(1, n - 1) for n in dec], 2048)
    # its own generator: the draws of the cases after it stay as they were
    serve_gen = torch.Generator(device=dev)
    serve_gen.manual_seed(4321)
    check_ragged(torch, serve_gen, dev, results, "ragged_serve", SERVE_ROUND, 2048)
    log("  int8 KV cache:")
    check_paged(torch, "paged_q8_decode", gen, dev, 1, [n - 1 for n in dec_lens], dec_lens,
                results, q8=True)
    check_paged(torch, "paged_q8_decode_b8", gen, dev, 1, [n - 1 for n in serve_lens],
                serve_lens, results, q8=True)
    check_paged(torch, "paged_q8_prefill_q0", gen, dev, 512, [0] * 4, [512] * 4, results,
                q8=True)
    check_paged(torch, "paged_q8_prefill_q1024", gen, dev, 512, [1024] * 4, [1536] * 4,
                results, q8=True)
    check_append_q8(torch, gen, dev, results)
    check_kv_write(torch, dev, results, q8=True)
    dec = [int(x) for x in torch.randint(1, 4096, (60,), generator=gen, device=dev)]
    check_ragged(torch, gen, dev, results, "ragged_q8",
                 [(512, 0), (512, 1024)] + [(1, n - 1) for n in dec], 2048, q8=True)
    log("  fused dequant matmul (the decode body at M <= 64, the Hopper kernel at prefill; v2 "
        "beside each on the same inputs):")
    for label, (K, N) in QMM_DECODE_WEIGHTS.items():
        check_qmm(torch, f"int8_m64_{label}_{K}x{N}", gen, dev, 64, K, N, "int8", 0, False,
                  results)
    check_qmm(torch, "int8_m64_head_fp32", gen, dev, 64, 4096, 128256, "int8", 0, True, results)
    check_qmm(torch, "int8_m4_head_fp32", gen, dev, 4, 4096, 128256, "int8", 0, True, results)
    check_qmm(torch, "int4_g0_m64_4096x14336", gen, dev, 64, 4096, 14336, "int4", 0, False,
              results)
    check_qmm(torch, "int4_g128_m64_4096x14336", gen, dev, 64, 4096, 14336, "int4", 128, False,
              results)
    for M in QMM_PREFILL_ROWS:
        for K, N in QMM_PREFILL_WEIGHTS:
            check_qmm(torch, f"int8_m{M}_{K}x{N}", gen, dev, M, K, N, "int8", 0, False, results)
        check_qmm(torch, f"int4_g128_m{M}_4096x14336", gen, dev, M, 4096, 14336, "int4", 128,
                  False, results)
    log("  contiguous flash attention (training shapes; the Hopper forward and backward, the "
        "older forward and backward by name beside them):")
    check_flash(torch, "flash_fwd_causal_s2048", gen, dev, 1, 2048, 2048, [0], [2048], results)
    check_flash(torch, "flash_fwd_q1024_kv1536", gen, dev, 4, 512, 1536, [1024] * 4, [1536] * 4,
                results)
    check_flash(torch, "flash_bwd_causal_s2048", gen, dev, 1, 2048, 2048, [0], [2048], results,
                backward=True)
    check_flash(torch, "flash_bwd_q1024_kv1536", gen, dev, 4, 512, 1536, [1024] * 4, [1536] * 4,
                results, backward=True)

    serves = {}
    for phase, plane, n_req, max_new, profile in ((3, "bf16", 8, 64, True),
                                                  (4, "int8+kv8", 8, 64, True),
                                                  (5, "int4g128+kv8", 2, 16, False)):
        log(f"phase {phase}: serve llama3-8b ({plane}, random weights) through LLMService")
        stats = asyncio.run(serve(torch, dev, plane, n_req, max_new, profile))
        log(f"  TTFT p50 {stats['ttft_p50_s']:.3f} s; decode "
            f"{stats['decode_tokens_per_s']:.1f} tokens/s aggregate, "
            f"{stats['decode_tokens_per_s_per_stream']:.1f} per stream ({card})")
        log("serve: " + json.dumps(stats))
        serves[plane] = stats

    log("phase 6: train llama3-8b (random weights) through K7, forward and backward")
    check = train_check(torch, dev)
    train = train_full(torch, dev, card)
    train["check"] = check
    log("train: " + json.dumps(train))

    src = "finchat_tpu_torch/csrc/"
    paged = "finchat_tpu/ops/paged_attention.py:305"
    q8_paged = "finchat_tpu/ops/paged_attention.py:221"
    ragged = "finchat_tpu/ops/ragged_paged_attention.py:383"
    q8_ragged = "finchat_tpu/ops/ragged_paged_attention.py:478"
    qmm = "finchat_tpu/ops/quant_matmul.py:144"
    flash = "finchat_tpu/ops/flash_attention.py:160"  # the backward: the gradient of it
    # kernel -> (source, TPU kernel it replaces, serving plane or training
    # run whose main path gives its launches)
    kernel_rows = {
        "paged_attention": ("paged_attention.cu", paged, "bf16"),
        "paged_attention_sm90": ("attention_bf16_sm90.cu", paged, "bf16"),
        "kv_append": ("kv_append.cu", "finchat_tpu/ops/kv_append.py:241", "bf16"),
        "kv_append_sm90": ("kv_write_sm90.cu", "finchat_tpu/ops/kv_append.py:241", "bf16"),
        "ragged_paged_attention": ("ragged_paged_attention.cu", ragged, "bf16"),
        "ragged_paged_attention_sm90": ("attention_bf16_sm90.cu", ragged, "bf16"),
        "ragged_paged_attention_decode_sm90": ("attention_decode_sm90.cu", ragged, "bf16"),
        "paged_attention_q8": ("paged_attention.cu", q8_paged, "int8+kv8"),
        "paged_attention_q8_sm90": ("attention_q8_sm90.cu", q8_paged, "int8+kv8"),
        "paged_attention_decode_sm90": ("attention_decode_sm90.cu", paged, "bf16"),
        "paged_attention_q8_decode_sm90": ("attention_decode_sm90.cu", q8_paged, "int8+kv8"),
        "kv_append_q8": ("kv_append.cu", "finchat_tpu/ops/kv_append.py:175", "int8+kv8"),
        "kv_append_q8_sm90": ("kv_write_sm90.cu", "finchat_tpu/ops/kv_append.py:175",
                              "int8+kv8"),
        "ragged_paged_attention_q8": ("ragged_paged_attention.cu", q8_ragged, "int8+kv8"),
        "ragged_paged_attention_q8_sm90": ("attention_q8_sm90.cu", q8_ragged, "int8+kv8"),
        "quant_matmul_int8": ("quant_matmul.cu", qmm, "int8+kv8"),
        "quant_matmul_int8_sm90": ("quant_matmul_sm90.cu", qmm, "int8+kv8"),
        "quant_matmul_int4": ("quant_matmul.cu", qmm, "int4g128+kv8"),
        "quant_matmul_int4_sm90": ("quant_matmul_sm90.cu", qmm, "int4g128+kv8"),
        "quant_matmul_int8_decode_sm90": ("quant_matmul_decode_sm90.cu", qmm, "int8+kv8"),
        "quant_matmul_int4_decode_sm90": ("quant_matmul_decode_sm90.cu", qmm, "int4g128+kv8"),
        "flash_attention": ("flash_attention.cu", flash, "train"),
        "flash_attention_sm90": ("attention_bf16_sm90.cu", flash, "train"),
        "flash_attention_bwd": ("flash_attention.cu", flash, "train"),
        "flash_attention_bwd_sm90": ("flash_attention_bwd_sm90.cu", flash, "train"),
    }
    launched = {plane: stats["launches"] for plane, stats in serves.items()}
    launched["train"] = train["launches"]
    table = []
    for r in results:
        kname = r["kernel"]
        source, replaces, plane = kernel_rows[kname]
        row = {
            "name": kname if r["case"] == kname else f"{kname}[{r['case']}]",
            "route": "cuda", "source": src + source, "replaces": replaces,
            "launches": launched[plane][kname], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        for key in ("wrapper_ms", "pair_ms"):
            if key in r:
                row[key] = r[key]
        table.append(row)
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
