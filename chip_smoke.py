#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``finchat_tpu_torch``), one H100.

    python3 chip_smoke.py            # every phase, as the acceptance run does

Phases, in order; any failure exits non-zero and prints no result line:

1. Device and build: the card's name and power limit (``nvidia-smi``), then
   the CUDA kernels built from ``finchat_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (build seconds printed).
2. Kernels against their plain PyTorch versions on the card, at the serving
   shapes of Llama-3-8B in bf16 (32 query heads, 8 KV heads, head_dim 128,
   page_size 128, 64 pages per sequence): paged attention (decode B=64 C=1
   over 1-4k-token contexts; prefill B=4 C=512 at q_offset 0 and 1024), the
   decode KV append (B=64 with invalid lanes), and ragged attention (two
   512-token prefill rows, 60 decode rows, padding to a 2048 bucket). Each
   case prints its max abs error and, for attention, the largest error of
   any output row (one token of one head) relative to that row's largest
   reference value; each row is held to min(2e-2, 2^-6 of that value), two
   bf16 ulps (the append is held bit-exact). Then it prints the kernel's
   and the plain version's median time over 20 CUDA-event-timed runs, the
   bound (the larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s, counted
   from this run's inputs) and, for attention, ``scaled_dot_product_attention`` over
   the pre-gathered KV on the same work (decode rows as one call, prefill
   rows as another) as a yardstick the port never calls.
3. Serve: ``llama3-8b`` with random bf16 weights from a seeded generator,
   ``EngineConfig`` defaults minus the planes not ported yet, behind the
   scheduler, ``EngineGenerator`` and ``LLMService``. Four greedy requests
   at once, four more once the first tokens stream (so prefill coexists
   with decode and the packed ragged rounds run), 64 new tokens each. Every
   request must complete; every kernel's launch count must move during this
   phase; one served stream is then checked teacher-forced against the
   plain dense forward (same weights, plain attention). Last, one decode
   step and one prefill chunk at the served context length are timed and
   profiled (device time by kernel class, and the device's idle share of
   the profiled window).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is visible or when the port package is not beside this file.
"""

from __future__ import annotations

import asyncio
import json
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
REPO = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

H, HKV, D, PS, MP = 32, 8, 128, 128, 64  # llama3-8b heads, page_size, pages/seq


def _cache(torch, gen, dev, n_layers: int, n_pages: int):
    shape = (n_layers, n_pages, PS, HKV * D)
    k = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    return k, v


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


def _gather_dense(torch, k_pages, v_pages, pt, layer: int, S: int):
    """Dense [B, Hkv, S, D] K/V of each sequence's first S tokens."""
    from finchat_tpu_torch.engine.kv_cache import gather_kv

    k, v = gather_kv(k_pages, v_pages, pt, PS, layer, HKV)
    return (k[:, :S].permute(0, 2, 1, 3).contiguous(), v[:, :S].permute(0, 2, 1, 3).contiguous())


def check_paged(torch, name, gen, dev, C: int, q_offsets: list[int], kv_lens: list[int],
                results: list) -> None:
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.paged_attention import paged_attention_ref, paged_flash_attention

    B, layer = len(kv_lens), 1
    n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
    k_pages, v_pages = _cache(torch, gen, dev, 2, n_pages)
    pt = _page_table(torch, gen, dev, kv_lens, n_pages)
    q = torch.randn((B, C, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
    q_off = torch.tensor(q_offsets, dtype=torch.int32, device=dev)
    kv = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    kw = dict(page_size=PS, n_kv=HKV)

    def kern():
        return paged_flash_attention(q, k_pages, v_pages, pt, q_off, kv, layer, **kw)

    def plain():
        return paged_attention_ref(q, k_pages, v_pages, pt, q_off, kv, layer, **kw)

    before = LAUNCHES["paged_attention"]
    got = kern()
    torch.cuda.synchronize()
    assert LAUNCHES["paged_attention"] == before + 1
    want = plain()
    live = kv > 0
    err, rel, close = attention_errors(torch, got[live], want[live])
    zeros_ok = bool((got[~live] == 0).all().item())
    finite = bool(torch.isfinite(got.float()).all().item())
    log(f"  {name}: max_abs_err {err:.3e}, row-relative {rel:.3e} (limit per row: "
        f"min({ATOL}, {REL_TOL} * max|want|)), "
        f"kv_len==0 rows zero: {zeros_ok}")
    if not (close and zeros_ok and finite):
        fail(f"{name}: kernel disagrees with its plain version (row-relative {rel}, "
             f"zeros {zeros_ok}, finite {finite})")
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain)
    S = max(kv_lens)
    k_rows, v_rows = _gather_dense(torch, k_pages, v_pages, pt, layer, S)
    pos = torch.arange(S, device=dev)
    qp = q_off[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    mask = (pos[None, None, :] <= qp[:, :, None]) & (pos[None, None, :] < kv[:, None, None])
    lib_ms = _sdpa_ms(torch, [(q.transpose(1, 2).contiguous(), k_rows, v_rows, mask[:, None])])
    kv_bytes = sum(kv_lens) * HKV * D * 2 * 2
    io_bytes = q.numel() * 2 * 2 + pt.numel() * 4 + B * 8
    flops = _attention_flops([(o + i, kl) for o, kl in zip(q_offsets, kv_lens) for i in range(C)])
    b_ms, b_by = bound_ms(kv_bytes + io_bytes, flops)
    log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    results.append(dict(case=name, err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    del k_pages, v_pages, k_rows, v_rows
    torch.cuda.empty_cache()


def check_append(torch, gen, dev, results: list) -> None:
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.kv_append import paged_kv_append, paged_kv_append_ref

    B, L, P = 64, 32, 512  # the serving cache: [32, 512, 128, 1024]
    HD = HKV * D
    k_pages = torch.zeros((L, P, PS, HD), dtype=torch.bfloat16, device=dev)
    v_pages = torch.zeros_like(k_pages)
    kv_lens = [int(x) for x in torch.randint(1, 4096, (B,), generator=gen, device=dev)]
    pt = torch.zeros((B, MP), dtype=torch.int32, device=dev)
    pt[:, :8] = (torch.arange(B * 8, device=dev, dtype=torch.int32).reshape(B, 8) % (P - 1)) + 1
    # positions inside each lane's first 8 pages; invalid lanes (every 8th)
    # at distinct offsets so their trash-page writes never collide
    pos = torch.tensor([(n % (8 * PS)) if b % 8 else b for b, n in enumerate(kv_lens)],
                       dtype=torch.int32, device=dev)
    n_valid = torch.tensor([0 if b % 8 == 0 else 1 for b in range(B)], dtype=torch.int32,
                           device=dev)
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

    def kern():
        paged_kv_append(kv_new, k_pages, v_pages, pt, pos, n_valid, layer, page_size=PS)

    def plain():
        paged_kv_append_ref(kv_new, k_ref, v_ref, pt, pos, n_valid, layer, page_size=PS)

    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain)
    moved = 2 * kv_new.numel() * 2 + B * (4 + 4 + 4)  # rows in, rows out, pos/valid/table
    b_ms, b_by = bound_ms(moved, 0.0)
    log(f"  kv_append: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    results.append(dict(case="kv_append", err=err, rel_err=None, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del k_pages, v_pages, k_ref, v_ref
    torch.cuda.empty_cache()


def check_ragged(torch, gen, dev, results: list) -> None:
    from finchat_tpu_torch.ops.kernels import LAUNCHES
    from finchat_tpu_torch.ops.ragged_paged_attention import (
        ragged_flash_attention,
        ragged_paged_attention_ref,
    )

    R, T, layer = 64, 2048, 1
    # rows 0-1: 512-token prefill chunks at q_offset 0 and 1024; rows 2-61:
    # decode rows over 1-4k contexts; rows 62-63: empty (padding rows)
    dec = [int(x) for x in torch.randint(1, 4096, (60,), generator=gen, device=dev)]
    spans = [(512, 0), (512, 1024)] + [(1, n - 1) for n in dec] + [(0, 0), (0, 0)]
    kv_lens = [q + p for q, p in spans[:62]] + [0, 0]
    n_pages = 2 + sum(max(1, -(-n // PS)) for n in kv_lens)
    k_pages, v_pages = _cache(torch, gen, dev, 2, n_pages)
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

    def kern():
        return ragged_flash_attention(q, k_pages, v_pages, pt, tr, tp, kv, layer, **kw)

    def plain():
        return ragged_paged_attention_ref(q, k_pages, v_pages, pt, tr, tp, kv, layer, **kw)

    before = LAUNCHES["ragged_paged_attention"]
    got = kern()
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_paged_attention"] == before + 1
    want = plain()
    err, rel, close = attention_errors(torch, got[:n_real], want[:n_real])
    zeros_ok = bool((got[n_real:] == 0).all().item())
    finite = bool(torch.isfinite(got.float()).all().item())
    log(f"  ragged: max_abs_err {err:.3e}, row-relative {rel:.3e} (limit per row: "
        f"min({ATOL}, {REL_TOL} * max|want|)), "
        f"padding tokens zero: {zeros_ok}")
    if not (close and zeros_ok and finite):
        fail(f"ragged: kernel disagrees with its plain version (row-relative {rel}, "
             f"zeros {zeros_ok}, finite {finite})")
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, iters=5, warmup=1)
    # yardstick on the same work: the two prefill rows as one call (B=2,
    # Sq=512), the 60 decode rows as another (B=60, Sq=1), each over its
    # rows' KV padded to the longest of them and masked
    S = max(kv_lens)
    k_rows, v_rows = _gather_dense(torch, k_pages, v_pages, pt, layer, S)
    pre, dec_r = slice(0, 2), slice(2, 62)
    s_pre, s_dec = max(kv_lens[pre]), max(kv_lens[dec_r])
    q_pre = q[:1024].reshape(2, 512, H, D).transpose(1, 2).contiguous()
    qpos_pre = torch.tensor([[p0 + i for i in range(512)] for _q, p0 in spans[pre]], device=dev)
    pos = torch.arange(S, device=dev)
    m_pre = ((pos[None, None, :s_pre] <= qpos_pre[:, :, None])
             & (pos[None, None, :s_pre] < kv[pre, None, None]))
    q_dec = q[1024:1084, :, None, :]  # [60, H, 1, D]
    m_dec = pos[None, None, None, :s_dec] < kv[dec_r, None, None, None]
    lib_ms = _sdpa_ms(torch, [
        (q_pre, k_rows[pre, :, :s_pre].contiguous(), v_rows[pre, :, :s_pre].contiguous(),
         m_pre[:, None]),
        (q_dec.contiguous(), k_rows[dec_r, :, :s_dec].contiguous(),
         v_rows[dec_r, :, :s_dec].contiguous(), m_dec),
    ])
    kv_bytes = sum(kv_lens) * HKV * D * 2 * 2
    io_bytes = q.numel() * 2 * 2 + pt.numel() * 4 + T * 8 + R * 4
    flops = _attention_flops([(p0 + i, kl) for (q_len, p0), kl in zip(spans, kv_lens)
                              for i in range(q_len)])
    b_ms, b_by = bound_ms(kv_bytes + io_bytes, flops)
    log(f"  ragged: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    results.append(dict(case="ragged", err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    del k_pages, v_pages, k_rows, v_rows
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 3: serve
# --------------------------------------------------------------------------

async def serve(torch, dev) -> dict:
    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.llama import PRESETS, init_params, n_params
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS

    config = PRESETS["llama3-8b"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(config, gen, dev)
    torch.cuda.synchronize()
    log(f"  llama3-8b: {config.n_layers} layers, {n_params(config) / 1e9:.2f} B params bf16, "
        f"random init {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(prefix_cache=False, session_cache=False, preemption=False,
                        breaker_threshold=0)
    engine = InferenceEngine(config, params, ecfg, device=dev)
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
    max_new = 64
    svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                     SamplingParams(temperature=0.0, max_new_tokens=max_new))
    contexts = [
        "Income: 6,200/month. Savings goal: emergency fund of 15,000.",
        "Recent transactions: groceries 142.10, rent 1,850.00, utilities 96.45. " * 6,
        "Accounts: checking 3,410; savings 8,900; 401k 41,250; credit card balance 1,240. " * 12,
        "Goal: pay off a 9,800 car loan at 6.9% APR within 18 months. " * 20,
        "User profile: 29 years old, salaried, contributes 6% to a 401k with 4% match. " * 4,
        "Spending last month: dining 410, travel 980, subscriptions 64, fuel 188. " * 10,
        "Debts: student loan 22,400 at 5.1%; no other debt. Risk appetite: moderate. " * 16,
        "Question context: considering a Roth IRA versus paying extra on the student loan. " * 8,
    ]
    messages = [f"Request {i}: what should I do next with my money?" for i in range(8)]
    reset_launches()
    await sched.start()

    async def one(i: int) -> str:
        text = []
        async for chunk in svc.process_message(messages[i], context=contexts[i]):
            text.append(chunk)
        return "".join(text)

    t_start = time.perf_counter()
    wave1 = [asyncio.create_task(one(i)) for i in range(4)]
    while not any(h.generated > 0 for h in handles):
        await asyncio.sleep(0.005)
    wave2 = [asyncio.create_task(one(i)) for i in range(4, 8)]
    await asyncio.gather(*wave1, *wave2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    await sched.stop()
    launches = dict(LAUNCHES)
    prompt_lens = [len(h.prompt_ids) for h in handles]
    log(f"  served {len(handles)} requests in {wall:.2f} s; prompt tokens {prompt_lens}")
    log(f"  launches during serve: {launches}")
    if len(handles) != 8 or not all(h.finished and h.generated > 0 for h in handles):
        fail("serve: not every request completed with tokens")
    if not all(h.generated == max_new or h.history[-1] == tok.eos_id for h in handles):
        fail("serve: a request ended before max_new_tokens without EOS")
    if not all(launches[k] > 0 for k in launches):
        fail(f"serve: a kernel was not launched on the main path: {launches}")
    if sched.allocator.used_count != 0:
        fail(f"serve: {sched.allocator.used_count} KV pages still allocated after the run")
    ttfts = sorted(h.first_token_at - h.submitted_at for h in handles)
    ttft_p50 = statistics.median(ttfts)
    decode_tokens = sum(h.generated - 1 for h in handles)
    t_first = min(h.first_token_at for h in handles)
    t_last = max(h.last_token_at for h in handles)
    agg_tps = decode_tokens / max(t_last - t_first, 1e-9)
    per_stream = statistics.median(
        (h.generated - 1) / max(h.last_token_at - h.first_token_at, 1e-9) for h in handles)
    mixed = METRICS.get("finchat_mixed_dispatches_total")
    coexist = METRICS.get("finchat_coexist_iterations_total")
    log(f"  ragged rounds {mixed:.0f}, coexist iterations {coexist:.0f}")
    if mixed < 1:
        fail("serve: no packed ragged round ran (prefill never coexisted with decode)")
    check = teacher_forced_check(torch, params, config, handles)
    steps = profile_steps(torch, engine, context=max(prompt_lens), active=len(handles))
    del engine, sched, svc
    return dict(ttft_p50_s=ttft_p50, ttft_s=ttfts, decode_tokens_per_s=agg_tps,
                decode_tokens_per_s_per_stream=per_stream, wall_s=wall,
                prompt_tokens=prompt_lens, launches=launches, ragged_rounds=mixed,
                teacher_forced=check, steps=steps)


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "paged_attention_kernel" in n or "ragged_attention_kernel" in n or "combine_splits" in n:
        return "attention (ours)"
    if "kv_append" in n:
        return "kv_append (ours)"
    if any(k in n for k in ("gemm", "gemv", "xmma", "cutlass", "sm90", "nvjet", "matmul")):
        return "matmul (cuBLAS)"
    return "other"


def profile_steps(torch, engine, context: int, active: int) -> dict:
    """Where a step's time goes, after serving: a decode step with ``active``
    slots at ``context`` tokens, and a 4 x 512 prefill chunk at q_offset
    2048, each timed with CUDA events around whole steps (host enqueue
    included) and profiled with torch.profiler for device time by kernel
    class. The idle share is 1 - device busy / window, both taken in the
    same profiled window: CUDA events recorded inside the profile around
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

    out = {}
    for name, fn in (("decode_step", decode), ("prefill_chunk_4x512", prefill)):
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
        by_class: dict[str, float] = {}
        others: dict[str, float] = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue  # host ops also carry their kernels' device time
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us:
                cls = _kernel_class(ev.key)
                by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3 / 3
                if cls == "other":
                    others[ev.key[:60]] = dev_us / 1e3 / 3
        ev_ms = time_ms(torch, fn, iters=5, warmup=1)
        busy = sum(by_class.values())
        top_other = dict(sorted(others.items(), key=lambda x: -x[1])[:4])
        out[name] = dict(event_ms=ev_ms, profiled_window_ms=window_ms, device_busy_ms=busy,
                         idle_share=1.0 - busy / window_ms,
                         device_ms_by_class=by_class, top_other=top_other)
        log(f"  {name}: {ev_ms:.2f} ms per step (CUDA events); profiled {window_ms:.2f} ms "
            f"per step, device busy {busy:.2f} ms (idle share {1.0 - busy / window_ms:.3f}): "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_class.items(), key=lambda x: -x[1])))
    engine.reset_slots(list(range(active)))
    return out


def teacher_forced_check(torch, params, config, handles) -> dict:
    """Re-run the shortest served stream through the plain dense forward
    (same weights, plain attention, no cache) and require the served greedy
    token wherever the plain forward's top-2 logit margin exceeds 0.25 —
    bf16 activations through 32 layers move logits by a few hundredths, so
    a larger margin cannot flip."""
    from finchat_tpu_torch.models.llama import forward_full

    h = min(handles, key=lambda x: len(x.prompt_ids))
    ids = h.history[:-1]
    n_prompt = len(h.prompt_ids)
    dev = params["embed"].device
    tokens = torch.tensor([ids], dtype=torch.int64, device=dev)
    positions = torch.arange(len(ids), device=dev)[None]
    with torch.no_grad():
        logits = forward_full(params, tokens, positions, config=config)[0, n_prompt - 1:]
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
    return dict(tokens=n, agree=int(agree.sum()), decided=int(decided.sum()))


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

    log("phase 2: kernels against their plain versions (bf16, llama3-8b shapes)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results: list[dict] = []
    dec_lens = [int(x) for x in torch.randint(1, 4097, (64,), generator=gen, device=dev)]
    check_paged(torch, "paged_decode", gen, dev, 1, [n - 1 for n in dec_lens], dec_lens, results)
    check_paged(torch, "paged_prefill_q0", gen, dev, 512, [0] * 4, [512] * 4, results)
    check_paged(torch, "paged_prefill_q1024", gen, dev, 512, [1024] * 4, [1536] * 4, results)
    check_append(torch, gen, dev, results)
    check_ragged(torch, gen, dev, results)

    log("phase 3: serve llama3-8b (bf16, random weights) through LLMService")
    serve_stats = asyncio.run(serve(torch, dev))
    log(f"  TTFT p50 {serve_stats['ttft_p50_s']:.3f} s; decode "
        f"{serve_stats['decode_tokens_per_s']:.1f} tokens/s aggregate, "
        f"{serve_stats['decode_tokens_per_s_per_stream']:.1f} per stream ({card})")
    log("serve: " + json.dumps(serve_stats))

    src = "finchat_tpu_torch/csrc/"
    by_case = {r["case"]: r for r in results}
    launches = serve_stats["launches"]
    rows = [
        ("paged_attention", "paged_decode", "paged_attention.cu",
         "finchat_tpu/ops/paged_attention.py:305"),
        ("paged_attention", "paged_prefill_q0", "paged_attention.cu",
         "finchat_tpu/ops/paged_attention.py:305"),
        ("paged_attention", "paged_prefill_q1024", "paged_attention.cu",
         "finchat_tpu/ops/paged_attention.py:305"),
        ("kv_append", "kv_append", "kv_append.cu", "finchat_tpu/ops/kv_append.py:241"),
        ("ragged_paged_attention", "ragged", "ragged_paged_attention.cu",
         "finchat_tpu/ops/ragged_paged_attention.py:383"),
    ]
    table = []
    for kname, case, source, replaces in rows:
        r = by_case[case]
        table.append({
            "name": kname if case == kname else f"{kname}[{case}]",
            "route": "cuda", "source": src + source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
