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
   ``EngineConfig``'s defaults with only ``kv_quant`` and the session disk
   tier's directory (a temporary one) set — the prefix and session KV
   caches, recompute preemption and the circuit breaker on — behind the
   scheduler, ``EngineGenerator`` and ``LLMService``. The engine's
   ``warmup()`` runs first, as the app runs it at start: its seconds, step
   variants, launches by kernel and peak memory are printed, and every page
   but the trash page must still be all zero after it (one device
   reduction). The rendered system head is registered first, as the
   app registers it (BOS added, the last token dropped: 30 whole pages);
   then four greedy requests at once, four more once the first tokens
   stream (so prefill coexists with decode and the packed ragged rounds
   run), 64 new tokens each, each its own conversation. Every request must
   complete; every kernel of the plane must be launched in this window
   (counts set to 0 just before the registration), the older paged body
   may not be launched at all (nor K3 on the bf16 plane, nor, on the
   quantized planes, K8's v2: every matmul of at most 64 rows, decode
   steps and heads, goes to the decode body), and the Hopper prefill body
   of the plane's cache must take every prefill chunk, one launch a layer;
   the KV-row writer of the plane's cache must take every cache write, one
   launch a layer of every decode step, prefill chunk and ragged round, and
   the older appends none. The prefix cache must hit 8/8, saving 8 x 3,840
   tokens, and the prefill rows and tokens the steps carried must equal
   what the prompts need past the head. Every served stream is then checked
   teacher-forced against the plain dense forward (same weights, plain
   attention). Turn 2: four of the conversations send their history plus a
   new message (16 new tokens), on the same scheduler: 4/4 must resume from
   their cached pages (RAM or disk) and prefill only the rest; then the
   head's pages must be bit-identical to their state just after the
   registration. Turn 3: after ``spill_sessions()`` and
   ``retire_prefixes()`` (no page may stay allocated), a fresh scheduler on
   the same engine and directory registers the head again and two
   conversations resume from disk (2/2). Each later turn is a window of its
   own for the launch rules and the teacher-forced checks, and prints its
   TTFT and its restore and offload seconds. Then one decode step, one
   prefill chunk and one serve-shaped ragged round at the served context
   length are timed and profiled (device time by kernel class, and the
   device's idle share of the profiled window). Then the resilience drills
   on the same weights. The breaker drill: on the serve's engine, four
   requests stream over the registered head; once each has 2 tokens,
   ``scheduler.decode`` fails ``breaker_threshold`` times (a fault armed
   only inside the drill); the trip rebuilds the pool on the card, an
   ``on_rebuild`` callback re-registers the head, and the streams replay
   cold. Every stream must complete teacher-forced, the rebuild counter rise
   by one and the breaker close; every kernel of the plane must launch
   after the trip (counts set to 0 in the callback) with the serve's launch
   rules, and no older body; peak memory across the rebuild must stay below
   the memory held before the drill plus one pool; a request after the drill
   must hit the re-registered head. The rebuild and recovery seconds and the
   replays' first token after the trip are printed. The preemption drill: a
   second engine over the same weights whose pool holds the head's pages
   and two requests' own pages but not three; two requests without a
   deadline, then one with a deadline 60 s out, which must preempt (at
   least one preemption; all three teacher-forced, each ending at its
   budget or EOS); then two more requests and ``shutdown_drain()`` once each
   has a token: each must end with the ``shutting_down`` error, its history
   on the session tier's disk, and no page left but the head's.
   Tracing: turn 1 runs traced (every request with a ``trace_id``; tracing
   is on by default): each request's timeline must hold its lifecycle
   marks, and the dispatch events must name it in their rows exactly as
   often as the engine's steps carried its slot (counted at the engine);
   the window is written as a Chrome trace, and tracing's host µs a decode
   dispatch is measured at 8 and 64 rows. The breaker drill writes the
   flight recorder to a temporary directory: the trip's dump must load with
   its checksum (``load_flight_dump``) and hold the trip and dispatches.
   ``device_trace`` over two decode steps must write a profiler trace with
   the engine's ``kv_append`` and ``paged_attention`` ranges, one a layer.
   The agent's planes, after the later turns on the serve's engine with the
   head registered on a scheduler of their own: grammar-constrained decode
   with the tool grammar bound to the model's 128,256-wide vocab (its
   ``GrammarVocab`` constructor over ``ByteTokenizer``'s texts, empty texts
   past them), four constrained and four plain requests, greedy, 64 new
   tokens at most, in waves that send a constrained row down every path
   (the prefill round's pick, the ragged round's completions and decode
   rows, a depth-2 step a pending slot sits out, the depth-1 step when
   every decoding slot waits on a pick). Every constrained output must
   leave the DFA live or accepting and parse; every plain stream passes the
   teacher-forced check, every constrained one the same check under the
   grammar mask each token was picked under; a slot that sat out a step
   must keep its context length and last token, and for the first four
   such steps every page of its context bit-identical; the serve's launch
   rules hold. Then a decode step's time with one constrained row against
   none, the fetch of one logits row and the host pick. On bf16, partial
   holds: ``submit_partial`` of the rendered head plus context, parked,
   grafted by ``extend_prompt`` after 0.2 s (the retrieval), teacher-forced,
   ``finchat_partial_grafts_total`` up by one, TTFT from the graft printed
   beside a plain submit's of the same prompt; a divergent graft must be
   refused and its cancel leave no own page and the head's refcount as it
   was. Then the agent (``agent_turns``): Penny turns through
   ``LLMAgent.stream_with_status`` on a scheduler of its own at
   ``EngineConfig()`` with both of the agent's prompt heads registered, the
   prompts of ``prompts/``, a fake retriever (0.2 s, fixed rows), greedy,
   96 decision and 64 response tokens at most. Four engine-decided turns,
   two at a time, both roles on the model (the decision's tool grammar
   bound through the generator's own ``GrammarVocab.for_tokenizer`` over a
   ``ByteTokenizer`` as wide as the logits rows): the reference's event
   protocol, the decision accepting and the streamed parser agreeing with
   ``parse_tool_decision``, both streams teacher-forced (the decision under
   its grammar mask), one graft a retrieving turn with the hold taken at
   name-commit, the pages after the turns those before. Then two turns
   decided by a paced ``StubGenerator`` with the overlap and tool streaming
   on, then off: byte-identical responses; on, one launch a turn adopted,
   the hold at name-commit (trace marks) and grafted, the response TTFT
   from the turn's start and ``finchat_tool_overlap_saved_seconds``
   printed on and off. Every kernel of the plane must launch in these
   turns, under the serve's launch rules. Last, a turn abandoned once its
   response has a token: no hold, slot or own page left, the heads'
   refcounts unchanged.
   Then ``app_turns``, once the serve's engine and weights are released: the
   serving app at full width, bf16 — ``build_app`` builds the 8B itself
   (random weights from ``model.seed``, a ``ByteTokenizer`` as wide as the
   logits rows, ``EngineConfig()``'s defaults, warmup, both prompt heads
   registered), over an ``InMemoryBroker``, an ``InMemoryStore`` of four
   conversations and the agent's fake retriever, greedy, 64 new tokens.
   Driven through the consume loop: four messages at once, a second turn of
   two conversations (resumed through the session cache), a redelivered
   answered message (deduped, nothing produced); over HTTP ``/health``,
   a ``/chat/stream`` turn, ``/metrics`` and ``/debug/trace/<message_id>``;
   then ``drain_and_stop()`` (no slot or page left beyond the heads, the
   session entries on disk, the journal holding exactly the answered ids).
   Every outbound record follows the chunk protocol, each stored answer is
   its turn's chunks, every stream is teacher-forced, and every bf16
   serving kernel launched under the serve's launch rules. It prints the
   build's seconds and peak memory, TTFT from Kafka ingress (the trace's
   ingress event to the response's first token) and the app's share of it,
   the same for the HTTP turn, and the phase's seconds.
4. Serve the quantized plane the same way: int8 weights made by
   ``init_quantized_params`` (the bf16 tree never exists) and an int8 KV
   pool, warmed up, the same head, 8 requests in two waves and later turns.
   The teacher-forced check runs the plain forward on the dequantized
   weights with every K/V row quantized and dequantized as the cache stores
   it; the traced window, the constrained decode (its head through K8's
   decode body), one pair of the agent's engine-decided turns, then the
   step profile and the breaker drill (the pool rebuilt with its scale
   planes) with its flight dump.
5. Serve int4 weights (per group of 128) over the int8 KV pool, warmed
   up: the head registered, two requests, one after the other's first token, 16 new
   tokens each, with the same prefix-cache and teacher-forced checks — the
   path of the int4 matmul kernel.
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


MESSAGES = [f"Request {i}: what should I do next with my money?" for i in range(8)]
# the resilience drills' streams: new tokens each
DRILL_NEW = 32


class _Counts:
    """What the engine's steps did in a window: prefill chunks
    (``prefill_chunk`` calls: one launch of the Hopper prefill body a
    layer), and the prefill rows and tokens they and the ragged rounds
    carried (a row of the round that reads its token from the device is a
    decode row, not a prefill row)."""

    def __init__(self, engine):
        self.engine = engine
        self.chunks = self.rows = self.tokens = 0
        prefill_chunk, ragged_mixed = engine.prefill_chunk, engine.ragged_mixed

        def counting_prefill_chunk(tokens, slots, start_pos, n_valid):
            self.chunks += 1
            self.rows += sum(1 for n in n_valid if n > 0)
            self.tokens += int(sum(n_valid))
            return prefill_chunk(tokens, slots, start_pos, n_valid)

        def counting_ragged_mixed(tokens, tok_row, row_slot, row_start, row_len,
                                  row_from_device, *rest):
            live = [int(n) for n, d in zip(row_len, row_from_device) if n > 0 and not d]
            self.rows += len(live)
            self.tokens += sum(live)
            return ragged_mixed(tokens, tok_row, row_slot, row_start, row_len,
                                row_from_device, *rest)

        engine.prefill_chunk = counting_prefill_chunk
        engine.ragged_mixed = counting_ragged_mixed

    def reset(self) -> None:
        self.chunks = self.rows = self.tokens = 0

    def close(self) -> None:
        del self.engine.prefill_chunk, self.engine.ragged_mixed


class _DispatchBook:
    """Which requests the engine's steps carried, counted at the engine (not
    from the trace): a prefill chunk carries the slots of its rows with
    tokens, a ragged round the slots of its rows with tokens, a decode step
    its active slots; each is booked to the request in that slot. Rows of a
    prefix registration (no request) are not booked."""

    NAMES = ("prefill_chunk", "ragged_mixed", "decode")

    def __init__(self, engine, sched):
        self.engine, self.counts = engine, {}
        self.saved = {n: (n in vars(engine), getattr(engine, n)) for n in self.NAMES}

        def book(slots):
            live = {h.slot: h for h in list(sched.prefilling) + list(sched.decoding.values())}
            for slot in slots:
                if slot in live:
                    self.counts[live[slot].seq_id] = self.counts.get(live[slot].seq_id, 0) + 1

        prefill_chunk, ragged_mixed, decode = (self.saved[n][1] for n in self.NAMES)

        def booked_prefill_chunk(tokens, slots, start_pos, n_valid):
            book([int(s) for s, n in zip(slots, n_valid) if n > 0])
            return prefill_chunk(tokens, slots, start_pos, n_valid)

        def booked_ragged_mixed(tokens, tok_row, row_slot, row_start, row_len, *rest):
            book([int(s) for s, n in zip(row_slot, row_len) if n > 0])
            return ragged_mixed(tokens, tok_row, row_slot, row_start, row_len, *rest)

        def booked_decode(active, *a, **k):
            book([s for s, on in enumerate(active) if on])
            return decode(active, *a, **k)

        engine.prefill_chunk = booked_prefill_chunk
        engine.ragged_mixed = booked_ragged_mixed
        engine.decode = booked_decode

    def close(self) -> None:
        for name, (had, fn) in self.saved.items():
            if had:
                setattr(self.engine, name, fn)
            else:
                delattr(self.engine, name)


def trace_cost_us(sched, rows: int, n: int = 20000, block: int = 2000) -> tuple[float, float]:
    """Host µs a dispatch pays for tracing: the decode dispatch's row list
    for ``rows`` members built and recorded through the scheduler's own
    ``_trace_dispatch``, as ``_dispatch_decode`` does under
    ``TRACER.enabled``. The ring's events are objects the garbage collector
    walks, so the cost grows with what the ring holds: the mean of the first
    ``block`` calls (the ring nearly empty) and of the last (``n`` events
    in it)."""
    from types import SimpleNamespace

    from finchat_tpu_torch.utils.tracing import TRACER

    members = [(s, SimpleNamespace(trace_id=f"trace-{s}", seq_id=f"seq-{s}"), 0)
               for s in range(rows)]
    TRACER.clear()
    means = []
    for _ in range(n // block):
        t0 = time.perf_counter()
        for _ in range(block):
            if TRACER.enabled:
                sched._trace_dispatch("decode", [[slot, h.trace_id or h.seq_id, "decode"]
                                                 for slot, h, _e in members])
        means.append((time.perf_counter() - t0) / block * 1e6)
    TRACER.clear()
    return means[0], means[-1]


def check_traced_window(plane: str, handles, book: _DispatchBook, sched) -> dict:
    """Turn 1 ran traced: every request's timeline (``TRACER.export``) holds
    its lifecycle marks and the request span, and the dispatch events whose
    rows name its trace id are exactly as many as the steps that carried it
    (``_DispatchBook``). The window is written as one Chrome trace (the
    requests' exports merged) to a temporary file, and tracing's host cost a
    dispatch is measured (``trace_cost_us``)."""
    import tempfile

    from finchat_tpu_torch.utils.tracing import TRACER

    events = TRACER.snapshot()
    merged, per = {}, {}
    for h in handles:
        tid = h.trace_id
        rows = sum(1 for ev in events if ev[2] == "dispatch"
                   and any(r[1] == tid for r in ev[5]["rows"]))
        export = TRACER.export(tid)
        names = {e["name"] for e in export["traceEvents"]}
        per[h.seq_id] = dict(dispatch_rows=rows, booked=book.counts.get(h.seq_id, 0),
                             events=len(export["traceEvents"]))
        if not {"admitted", "prefill_done", "first_token", "done", "request"} <= names:
            fail(f"traced serve ({plane}): {tid}'s timeline lacks marks: {sorted(names)}")
        if rows != per[h.seq_id]["booked"] or rows == 0:
            fail(f"traced serve ({plane}): {tid} is in the rows of {rows} dispatches, the "
                 f"steps carried it {per[h.seq_id]['booked']} times")
        for e in export["traceEvents"]:
            merged[(e["ts"], e["name"], e["tid"])] = e
    path = Path(tempfile.mkdtemp(prefix="finchat-trace-")) / f"serve-{plane}.json"
    path.write_text(json.dumps({"traceEvents": sorted(merged.values(), key=lambda e: e["ts"]),
                                "displayTimeUnit": "ms"}))
    n_dispatch = sum(1 for ev in events if ev[2] == "dispatch")
    cost = {rows: trace_cost_us(sched, rows) for rows in (8, 64)}
    log(f"  traced serve ({plane}): {len(events)} events, {n_dispatch} dispatches; each "
        f"request in as many dispatch rows as steps carried it "
        f"({[v['dispatch_rows'] for v in per.values()]}); the window as a Chrome trace, "
        f"{path.stat().st_size} bytes; tracing's host cost a decode dispatch: "
        + "; ".join(f"{rows} rows {a:.2f} µs (the ring nearly empty), {b:.2f} µs (20,000 "
                    "events in it)" for rows, (a, b) in cost.items()))
    path.unlink()
    path.parent.rmdir()
    return dict(events=len(events), dispatches=n_dispatch, requests=per,
                host_us_per_dispatch={str(k): list(v) for k, v in cost.items()})


def _metric_delta(metrics, before: dict, name: str) -> float:
    return metrics.snapshot().get(name, 0.0) - before.get(name, 0.0)


def _seconds(metrics, before: dict, name: str) -> dict:
    """A histogram's observations in a window: count, total and mean s."""
    n = _metric_delta(metrics, before, f"{name}_count")
    total = _metric_delta(metrics, before, f"{name}_sum")
    return dict(n=int(n), total_s=total, mean_s=total / n if n else None)


def check_window(plane: str, what: str, spec: dict, config, launches: dict, counts: _Counts,
                 decode_steps: float, rounds: float) -> None:
    """The launch rules every serving window holds: the Hopper prefill body
    of the cache takes every prefill chunk, one launch a layer, and the
    older paged body none; the KV-row writer of the cache takes every cache
    write, one launch a layer of every decode step, prefill chunk and ragged
    round; no kernel the routing keeps off this path is launched."""
    older = "paged_attention_q8" if spec["kv_quant"] else "paged_attention"
    want_chunks = counts.chunks * config.n_layers
    log(f"  {what}: prefill chunks {counts.chunks}: {launches[older + '_sm90']} launches of the "
        f"Hopper prefill body (want {want_chunks}), {launches[older]} of the older paged body")
    if launches[older] != 0:
        fail(f"serve {plane} ({what}): {launches[older]} calls reached the older paged body")
    if launches[older + "_sm90"] != want_chunks:
        fail(f"serve {plane} ({what}): the Hopper prefill body took "
             f"{launches[older + '_sm90']} calls, not one a layer of each of {counts.chunks} "
             "prefill chunks")
    stray = {k: launches[k] for k in spec.get("never", ()) if launches[k]}
    if stray:
        fail(f"serve {plane} ({what}): calls reached kernels the routing keeps off this path: "
             f"{stray}")
    writer, older_append = (("kv_append_q8_sm90", "kv_append_q8") if spec["kv_quant"]
                            else ("kv_append_sm90", "kv_append"))
    want_writes = int(config.n_layers * (decode_steps + counts.chunks + rounds))
    log(f"  {what}: KV writes: {launches[writer]} launches of {writer} (want {want_writes} = "
        f"{config.n_layers} x ({decode_steps:.0f} decode steps + {counts.chunks} chunks + "
        f"{rounds:.0f} rounds)), {launches[older_append]} of the older append")
    if launches[writer] != want_writes:
        fail(f"serve {plane} ({what}): the KV-row writer took {launches[writer]} layer writes, "
             f"not one a layer of every step ({want_writes})")


def check_prefill_rows(plane: str, what: str, handles, counts: _Counts, chunk: int,
                       start_of) -> None:
    """Every request prefilled its prompt from where its cached KV ends
    (``start_of(handle)``), in chunks of ``chunk``: the rows and tokens the
    engine's steps carried equal what the prompt lengths need."""
    want_rows = sum(-(-(len(h.prompt_ids) - start_of(h)) // chunk) for h in handles)
    want_tokens = sum(len(h.prompt_ids) - start_of(h) for h in handles)
    cold_rows = sum(-(-len(h.prompt_ids) // chunk) for h in handles)
    log(f"  {what}: prefill rows {counts.rows} carrying {counts.tokens} tokens (want "
        f"{want_rows} rows, {want_tokens} tokens; {cold_rows} rows without the caches)")
    if (counts.rows, counts.tokens) != (want_rows, want_tokens):
        fail(f"serve {plane} ({what}): the steps prefilled {counts.rows} rows / {counts.tokens} "
             f"tokens, the prompts need {want_rows} / {want_tokens}")


async def _stream_ids(sched, seq_id: str, ids: list[int], sampling, conversation_id: str):
    handle = await sched.submit(seq_id, ids, sampling, conversation_id=conversation_id)
    while True:
        event = await handle.events.get()
        if event["type"] == "done":
            return handle
        if event["type"] == "error":
            fail(f"{seq_id}: {event['message']}")


def _head_equal(torch, before: tuple, after: tuple) -> bool:
    return all((a is None and b is None) or torch.equal(a, b) for a, b in zip(before, after))


def pool_bytes(engine) -> int:
    """Device bytes of the engine's KV pool (pages and scale planes)."""
    s = engine.state
    return sum(t.numel() * t.element_size()
               for t in (s.k_pages, s.v_pages, s.k_scales, s.v_scales) if t is not None)


def pages_zero_past_trash(torch, engine) -> bool:
    """Whether every page but the trash page 0 is all zero, K, V and the
    scale planes: one min/max reduction a tensor over its pages 1.., one
    amax over their results, one host read."""
    s = engine.state
    ends = [torch.stack(torch.aminmax(t[:, 1:])).float().abs()
            for t in (s.k_pages, s.v_pages, s.k_scales, s.v_scales) if t is not None]
    return float(torch.cat(ends).amax().item()) == 0.0


def run_warmup(torch, plane: str, engine, weight_gb: float) -> dict:
    """``engine.warmup()`` as the app runs it at start: its seconds, its
    variant count, its launches by kernel (counts set to 0 just before), its
    peak memory, and the pool checked untouched past the trash page."""
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    seconds = engine.warmup()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    zero = pages_zero_past_trash(torch, engine)
    log(f"  warmup ({plane}): {engine.compiled_variants} step variants in {seconds:.2f} s; "
        f"peak {peak_gb:.2f} GB (weights {weight_gb:.2f}, pool {pool_bytes(engine) / 1e9:.2f}); "
        f"launches {launches}; pages 1.. all zero after it: {zero}")
    if not zero:
        fail(f"warmup ({plane}) wrote a page other than the trash page")
    return dict(seconds=seconds, variants=engine.compiled_variants, launches=launches,
                peak_gb=peak_gb)


async def serve(torch, dev, plane: str, n_requests: int, max_new: int, profile: bool,
                later_turns: bool, drills: tuple = (), agent: tuple = ()) -> dict:
    """Serve ``n_requests`` greedy requests through ``LLMService`` on one
    serving plane (``PLANES``) at ``EngineConfig``'s defaults, the prefix
    and session caches, preemption and the breaker on: the engine warmed up
    first, as the app does, then the system head registered, half the
    requests at once, the rest once a first token streams, each its own
    conversation. Launch counts are set to 0 just before the head's
    registration and read just after the serve. With ``later_turns``, then
    turn 2 of four conversations on the same scheduler and turn 3 of two on
    a fresh one, each a window of its own. ``drills`` names the resilience
    drills to run on the same weights afterwards: "breaker" on this engine,
    "preemption" (with the shutdown drain) on a second, smaller one.
    Turn 1 is traced: every request carries a ``trace_id``, and the rows
    of the dispatch events must name each request exactly as often as the
    engine's steps carried its slot (``_DispatchBook``). ``agent`` names
    the agent planes to run on this engine after the later turns:
    "constrained", and "partial" with it (``agent_planes``)."""
    import shutil
    import tempfile

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.llama import PRESETS, init_params, n_params
    from finchat_tpu_torch.models.quant import init_quantized_params
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat_head
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

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
    disk_dir = tempfile.mkdtemp(prefix="finchat-sessions-")
    try:
        ecfg = EngineConfig(kv_quant=spec["kv_quant"], session_cache_disk_path=disk_dir)
        engine = InferenceEngine(config, params, ecfg, device=dev, quant=spec["quant"],
                                 quant_group=spec["group"])
        warm = run_warmup(torch, plane, engine, weight_gb)
        torch.cuda.reset_peak_memory_stats()
        counts = _Counts(engine)
        tok = ByteTokenizer()
        sched = ContinuousBatchingScheduler(engine, tok.eos_id)
        book = _DispatchBook(engine, sched)
        handles = []
        submit = sched.submit

        async def recording_submit(*a, **k):
            h = await submit(*a, **k)
            handles.append(h)
            return h

        sched.submit = recording_submit
        system_prompt = (REPO / "prompts" / "system_prompt.txt").read_text()
        # the head as the app registers it: BOS added, the last token dropped
        head_ids = tok.encode(render_chat_head(system_prompt), add_bos=True)[:-1]
        svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                         SamplingParams(temperature=0.0, max_new_tokens=max_new))
        m0 = METRICS.snapshot()
        reset_launches()
        shared = sched.register_prefix(head_ids)
        reg_chunks = counts.chunks
        head_pages = list(sched._prefixes[0].pages) if sched._prefixes else []
        log(f"  prefix cache: the system head ({len(head_ids)} tokens) registered as {shared} "
            f"shared tokens, {len(head_pages)} pages, in {reg_chunks} prefill chunks")
        if shared != (len(head_ids) // engine.page_size) * engine.page_size or not shared:
            fail(f"serve {plane}: the system head registered {shared} shared tokens")
        head0 = engine.offload_pages(head_pages)
        counts.reset()
        await sched.start()

        async def one(i: int) -> str:
            text = []
            async for chunk in svc.process_message(MESSAGES[i], context=CONTEXTS[i],
                                                   conversation_id=f"conv-{i}",
                                                   trace_id=f"trace-{plane}-{i}"):
                text.append(chunk)
            return "".join(text)

        TRACER.clear()
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
        sched.submit = submit  # break the wrapper's cycle so the tree can go
        launches = dict(LAUNCHES)
        book.close()
        tracing = check_traced_window(plane, handles, book, sched)
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
        if sched.quant_label != plane.replace("g128", ""):
            fail(f"serve {plane}: the scheduler reports quant label {sched.quant_label}")
        hits = _metric_delta(METRICS, m0, "finchat_prefix_hits_total")
        saved = _metric_delta(METRICS, m0, "finchat_prefix_tokens_saved_total")
        log(f"  prefix cache: {hits:.0f}/{n_requests} hits, {saved:.0f} prefill tokens saved "
            f"(want {n_requests} x {shared})")
        if hits != n_requests or saved != n_requests * shared or any(
                h.shared_len != shared for h in handles):
            fail(f"serve {plane}: {hits:.0f} prefix hits saving {saved:.0f} tokens, not "
                 f"{n_requests} saving {n_requests * shared}")
        check_prefill_rows(plane, "turn 1", handles, counts, ecfg.prefill_chunk,
                           lambda h: h.shared_len)
        ttfts = sorted(h.first_token_at - h.submitted_at for h in handles)
        ttft_p50 = statistics.median(ttfts)
        decode_tokens = sum(h.generated - 1 for h in handles)
        t_first = min(h.first_token_at for h in handles)
        t_last = max(h.last_token_at for h in handles)
        agg_tps = decode_tokens / max(t_last - t_first, 1e-9)
        per_stream = statistics.median(
            (h.generated - 1) / max(h.last_token_at - h.first_token_at, 1e-9) for h in handles)
        mixed = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
        coexist = _metric_delta(METRICS, m0, "finchat_coexist_iterations_total")
        log(f"  ragged rounds {mixed:.0f}, coexist iterations {coexist:.0f}; gauges: "
            f"weight bits {METRICS.get('finchat_quant_weight_bits'):.0f}, "
            f"KV bits {METRICS.get('finchat_quant_kv_bits'):.0f}")
        if mixed < 1:
            fail(f"serve {plane}: no packed ragged round ran (prefill never coexisted with "
                 "decode)")
        decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
        counts.chunks += reg_chunks  # the registration's chunks ran in this window too
        check_window(plane, "turn 1", spec, config, launches, counts, decode_steps, mixed)
        offload1 = _seconds(METRICS, m0, "finchat_session_offload_seconds")
        log(f"  session cache: {len(sched.session_cache)} entries in RAM "
            f"({sched.session_cache.resident_bytes / 2**20:.1f} MiB of "
            f"{ecfg.session_cache_bytes / 2**20:.0f}), offloads {offload1['n']} taking "
            f"{offload1['total_s']:.3f} s, "
            f"{_metric_delta(METRICS, m0, 'finchat_session_cache_offloaded_pages_total'):.0f} "
            "pages")
        if sched.allocator.used_count != len(head_pages):
            fail(f"serve {plane}: {sched.allocator.used_count} KV pages allocated after the serve, "
                 f"not the head's {len(head_pages)}")
        turn1 = dict(ttft_p50_s=ttft_p50, ttft_s=ttfts, prefix_hits=hits, tokens_saved=saved,
                     prefill_rows=counts.rows, offload=offload1)
        checks = [teacher_forced_check(torch, params, config, h, spec["kv_quant"])
                  for h in handles]
        turns = {}
        if later_turns:
            turns["turn2"] = await later_turn(
                torch, plane, spec, config, engine, sched, counts, handles[:4], 2, shared,
                METRICS, reset_launches, LAUNCHES, tok, params, SamplingParams, from_disk=False)
        if not _head_equal(torch, head0, engine.offload_pages(head_pages)):
            fail(f"serve {plane}: the shared head's pages changed during the serve")
        log(f"  the head's {len(head_pages)} pages are bit-identical after the serve")
        if later_turns:
            spilled = sched.spill_sessions()
            sched.retire_prefixes()
            log(f"  spilled {spilled} session entries; after retire_prefixes "
                f"{sched.allocator.used_count} pages allocated")
            if sched.allocator.used_count != 0:
                fail(f"serve {plane}: {sched.allocator.used_count} KV pages leaked")
            sched.session_cache.disk.close()
            # a fresh scheduler on the same engine and directory: a restart
            fresh = ContinuousBatchingScheduler(engine, tok.eos_id)
            turns["turn3"] = await later_turn(
                torch, plane, spec, config, engine, fresh, counts,
                turns["turn2"].pop("handles")[:2], 3, shared, METRICS, reset_launches, LAUNCHES, tok, params, SamplingParams,
                from_disk=True, head_ids=head_ids)
            turns["turn3"].pop("handles")
            sched = fresh
        sched.retire_prefixes()
        if sched.allocator.used_count != 0:
            fail(f"serve {plane}: {sched.allocator.used_count} KV pages still allocated")
        if sched.session_cache.disk is not None:
            sched.session_cache.disk.close()
        counts.close()
        agent_stats = (await agent_planes(torch, plane, spec, config, engine, params, head_ids,
                                          system_prompt, shared, partial="partial" in agent)
                       if "constrained" in agent else None)
        if "turns" in agent:
            agent_stats["turns"] = await agent_turns(
                torch, plane, spec, config, engine, params, system_prompt,
                pairs=2 if "overlap" in agent else 1, overlap_runs="overlap" in agent)
        steps = (profile_steps(torch, engine, context=max(prompt_lens), active=len(handles))
                 if profile else None)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        drill = {}
        if "breaker" in drills:
            drill["breaker"] = await breaker_drill(torch, plane, spec, config, engine, params,
                                                   head_ids, system_prompt, shared)
        del engine, sched, svc, recording_submit, submit, counts
        gc.collect()
        torch.cuda.empty_cache()
        if "preemption" in drills:
            drill["preemption"] = await preemption_drill(torch, dev, plane, spec, config, params,
                                                         head_ids, system_prompt, shared,
                                                         disk_dir)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(disk_dir, ignore_errors=True)
    return dict(plane=plane, ttft_p50_s=ttft_p50, ttft_s=ttfts, decode_tokens_per_s=agg_tps,
                decode_tokens_per_s_per_stream=per_stream, wall_s=wall,
                prompt_tokens=prompt_lens, launches=launches, ragged_rounds=mixed,
                weight_gb=weight_gb, peak_gb=peak_gb, teacher_forced=checks, steps=steps,
                shared_tokens=shared, turn1=turn1, warmup=warm, drills=drill, tracing=tracing,
                agent=agent_stats, **turns)


async def later_turn(torch, plane, spec, config, engine, sched, counts, prev, turn: int,
                     shared: int, metrics, reset_launches, launches_now, tok, params,
                     sampling_cls, from_disk: bool, head_ids=None) -> dict:
    """Turn ``turn`` of the conversations of ``prev`` (their handles of the
    turn before): each prompt is that turn's history plus a new message,
    16 new tokens, all submitted at once. Every conversation must resume
    from its own cached pages — from RAM or the disk tier, and only from
    disk with ``from_disk`` (a fresh scheduler, the head registered anew
    from ``head_ids``) — and prefill only what follows them."""
    m0 = metrics.snapshot()
    reset_launches()
    counts.reset()
    if head_ids is not None:
        if sched.register_prefix(head_ids) != shared:
            fail(f"serve {plane}: turn {turn}: the head did not register again")
    reg_chunks = counts.chunks
    counts.reset()
    await sched.start()
    sampling = sampling_cls(temperature=0.0, max_new_tokens=16)
    t_start = time.perf_counter()
    handles = await asyncio.gather(*[
        _stream_ids(sched, f"turn{turn}-{i}",
                    h.history + tok.encode(f" Follow-up {turn}.{i}: and after that?",
                                           add_bos=False),
                    sampling, h.conversation_id)
        for i, h in enumerate(prev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    await sched.stop()
    launches = dict(launches_now)
    n = len(prev)
    hits = _metric_delta(metrics, m0, "finchat_session_cache_hits_total")
    disk = _metric_delta(metrics, m0, "finchat_durability_disk_restores_total")
    restored = _metric_delta(metrics, m0, "finchat_session_cache_restored_tokens_total")
    restore = _seconds(metrics, m0, "finchat_session_restore_seconds")
    offload = _seconds(metrics, m0, "finchat_session_offload_seconds")
    disk_s = _seconds(metrics, m0, "finchat_durability_restore_seconds")
    prompt_lens = [len(h.prompt_ids) for h in handles]
    log(f"  turn {turn}: {n} conversations in {wall:.2f} s; prompt tokens {prompt_lens}, "
        f"resumed {[h.resumed_len for h in handles]}")
    log(f"  turn {turn}: session hits {hits:.0f}/{n} ({disk:.0f} from disk), restored tokens "
        f"{restored:.0f}; restores {restore['n']} taking {restore['total_s']:.3f} s, disk "
        f"reads {disk_s['n']} taking {disk_s['total_s']:.3f} s, offloads {offload['n']} "
        f"taking {offload['total_s']:.3f} s")
    if hits != n or any(h.resumed_len <= shared for h in handles):
        fail(f"serve {plane}: turn {turn}: {hits:.0f}/{n} session hits")
    if from_disk and disk != n:
        fail(f"serve {plane}: turn {turn}: {disk:.0f}/{n} conversations restored from disk")
    if not all(h.finished and h.generated > 0 for h in handles):
        fail(f"serve {plane}: turn {turn}: not every request completed with tokens")
    check_prefill_rows(plane, f"turn {turn}", handles, counts, engine.engine_cfg.prefill_chunk,
                       lambda h: h.resumed_len)
    decode_steps = _metric_delta(metrics, m0, "finchat_decode_dispatches_total")
    rounds = _metric_delta(metrics, m0, "finchat_mixed_dispatches_total")
    counts.chunks += reg_chunks
    check_window(plane, f"turn {turn}", spec, config, launches, counts, decode_steps, rounds)
    checks = [teacher_forced_check(torch, params, config, h, spec["kv_quant"]) for h in handles]
    ttfts = sorted(h.first_token_at - h.submitted_at for h in handles)
    return dict(handles=handles, ttft_p50_s=statistics.median(ttfts), ttft_s=ttfts,
                session_hits=hits, disk_restores=disk, restored_tokens=restored,
                restore=restore, disk_read=disk_s, offload=offload, wall_s=wall,
                prompt_tokens=prompt_lens, teacher_forced=checks)


def _as_served(h, prompt_ids: list[int]):
    """A handle seen with the prompt it was submitted with: a replay's
    ``prompt_ids`` hold its history at the preemption, and the
    teacher-forced check must cover every token it streamed."""
    from types import SimpleNamespace

    return SimpleNamespace(seq_id=h.seq_id, prompt_ids=prompt_ids, history=h.history,
                           shared_len=h.shared_len, resumed_len=h.resumed_len)


def _stream_ended(plane: str, what: str, h, eos_id: int) -> None:
    if not (h.finished and (h.generated == h.sampling.max_new_tokens
                            or h.history[-1] == eos_id)):
        fail(f"{what} ({plane}): {h.seq_id} ended after {h.generated} of "
             f"{h.sampling.max_new_tokens} tokens without EOS")


def check_trip_launches(plane: str, spec: dict, config, launches: dict, counts: _Counts,
                        decode_steps: float, rounds: float) -> None:
    """After the trip, every kernel of the plane launched (the Hopper bodies
    over the rebuilt pool), the serve's launch rules held, and no older body
    launched."""
    missing = [k for k in spec["kernels"] if launches[k] == 0]
    if missing:
        fail(f"breaker drill ({plane}): kernels not launched after the trip: {missing}")
    check_window(plane, "after the trip", spec, config, launches, counts, decode_steps, rounds)


async def breaker_drill(torch, plane: str, spec: dict, config, engine, params, head_ids,
                        system_prompt: str, shared: int) -> dict:
    """The circuit breaker at full width on the serve's engine and weights,
    at ``EngineConfig``'s defaults: four requests of the serve's shape
    stream over the registered head; once each has 2 tokens,
    ``scheduler.decode`` fails ``breaker_threshold`` times in a row. The
    trip rebuilds the pool on the card, an ``on_rebuild`` callback
    re-registers the head (``register_prefix_async``), and the streams
    replay: each must complete teacher-forced, the rebuild counter rise by
    one and the breaker close. Launch counts are set to 0 in the callback:
    every kernel of the plane must launch after the trip, and no older body.
    Peak memory across the rebuild must stay under the held memory plus one
    pool. A request after the drill must hit the re-registered head. The
    flight recorder writes to a temporary directory during the drill: the
    trip's dump must load through ``load_flight_dump`` (its checksum
    verified) and hold the trip and the tripped rounds' dispatches."""
    import shutil
    import tempfile

    from finchat_tpu_torch.engine.generator import EngineGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.serve.simple import LLMService
    from finchat_tpu_torch.utils import faults
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER, load_flight_dump

    log(f"  breaker drill ({plane}): 4 requests over the head, {DRILL_NEW} new tokens each")
    flight_dir = tempfile.mkdtemp(prefix="finchat-flight-")
    tok = ByteTokenizer()
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    if sched.breaker_threshold < 1 or not sched.preemption_enabled:
        fail(f"breaker drill ({plane}): EngineConfig's defaults lost the breaker or preemption")
    if sched.register_prefix(head_ids) != shared:
        fail(f"breaker drill ({plane}): the head did not register")
    counts = _Counts(engine)
    handles, prompts = [], {}
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        prompts[h.seq_id] = list(h.prompt_ids)
        return h

    sched.submit = recording_submit
    deliveries: dict[str, list[float]] = {}
    deliver = sched._deliver

    def timed_deliver(h, token_id):
        deliveries.setdefault(h.seq_id, []).append(time.perf_counter())
        deliver(h, token_id)

    sched._deliver = timed_deliver
    trip: dict = {}

    def on_rebuild():
        # the window after the trip starts here: nothing has run on the new pool
        trip.update(t=sched._breaker_tripped_at, rebuilt=time.perf_counter(),
                    m=METRICS.snapshot(),
                    register=asyncio.ensure_future(sched.register_prefix_async(head_ids)))
        reset_launches()
        counts.reset()

    sched.on_rebuild.append(on_rebuild)
    svc = LLMService(EngineGenerator(sched, tok), system_prompt,
                     SamplingParams(temperature=0.0, max_new_tokens=DRILL_NEW))

    async def one(i: int) -> None:
        async for _chunk in svc.process_message(MESSAGES[i], context=CONTEXTS[i],
                                                conversation_id=f"drill-{plane}-{i}"):
            pass

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    pool = pool_bytes(engine)
    torch.cuda.reset_peak_memory_stats()
    m0 = METRICS.snapshot()
    TRACER.configure(flight_dir=flight_dir)
    await sched.start()
    try:
        tasks = [asyncio.create_task(one(i)) for i in range(4)]
        while len(handles) < 4 or not all(h.generated >= 2 or h.finished for h in handles):
            await asyncio.sleep(0.005)
        faults.arm("scheduler.decode", faults.n_shot(
            sched.breaker_threshold, RuntimeError("drill: wedged decode dispatch")))
        try:
            await asyncio.gather(*tasks)
        finally:
            faults.disarm("scheduler.decode")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if "register" not in trip:
            fail(f"breaker drill ({plane}): the breaker never rebuilt the engine")
        re_registered = await trip["register"]
        if re_registered != shared:
            fail(f"breaker drill ({plane}): the head re-registered {re_registered} tokens")
        hits0 = METRICS.get("finchat_prefix_hits_total")
        await one(4)
        after = handles[4]
        hit = METRICS.get("finchat_prefix_hits_total") - hits0
    finally:
        faults.disarm_all()
        await sched.stop()
        TRACER.configure(flight_dir="")
        TRACER.flush_dumps()  # the dump threads have written before the files are read
    sched.submit = submit
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    dumps = sorted(Path(flight_dir).glob("flight-*-breaker_trip.json"))
    if len(dumps) != 1:
        fail(f"breaker drill ({plane}): {len(dumps)} breaker_trip flight dumps")
    record = load_flight_dump(str(dumps[0]))
    box = record["trace"]["traceEvents"]
    box_dispatches = sum(1 for e in box if e["name"] == "dispatch")
    dump_bytes = dumps[0].stat().st_size
    log(f"  breaker drill ({plane}): the flight dump {dumps[0].name} ({dump_bytes} "
        f"bytes) loads with its checksum: {len(box)} events, {box_dispatches} dispatches, "
        f"anomaly args {record['anomaly_args']}")
    if record["reason"] != "breaker_trip" or not box_dispatches or not any(
            e["name"] == "breaker_trip" for e in box):
        fail(f"breaker drill ({plane}): the flight dump lacks the trip or its dispatches")
    shutil.rmtree(flight_dir, ignore_errors=True)
    rebuilds = _metric_delta(METRICS, m0, "finchat_engine_rebuilds_total")
    failures = _metric_delta(METRICS, m0, "finchat_dispatch_failures_total")
    preemptions = _metric_delta(METRICS, m0, "finchat_preemptions_total")
    state = METRICS.get("finchat_breaker_state")
    rebuild_s = _seconds(METRICS, m0, "finchat_engine_rebuild_seconds")
    recovery_s = _seconds(METRICS, m0, "finchat_breaker_recovery_seconds")
    # a replay's first token after the trip (None: the stream had ended)
    replay_ttft = [next((t - trip["t"] for t in deliveries[h.seq_id] if t > trip["rebuilt"]),
                        None) for h in handles[:4]]
    log(f"  breaker drill ({plane}): {failures:.0f} failed rounds, {preemptions:.0f} "
        f"preemptions, {rebuilds:.0f} rebuild; rebuild {rebuild_s['total_s']:.4f} s, recovery "
        f"{recovery_s['total_s']:.3f} s; the replays' first token "
        f"{[t if t is None else round(t, 3) for t in replay_ttft]} s after the trip; "
        f"breaker state {state:.0f}")
    log(f"  breaker drill ({plane}): peak {(peak - held) / 1e9:.2f} GB above the "
        f"{held / 1e9:.2f} GB held (one pool is {pool / 1e9:.2f} GB); the request after the "
        f"drill: {hit:.0f} prefix hit, {after.shared_len} shared tokens")
    log(f"  breaker drill ({plane}): launches after the trip: "
        f"{ {k: v for k, v in launches.items() if v} }")
    if rebuilds != 1 or state != 0:
        fail(f"breaker drill ({plane}): {rebuilds:.0f} rebuilds, breaker state {state:.0f}")
    if peak - held >= pool:
        fail(f"breaker drill ({plane}): peak {(peak - held) / 1e9:.2f} GB above the held memory "
             f"reaches a second pool ({pool / 1e9:.2f} GB)")
    if hit != 1 or after.shared_len != shared:
        fail(f"breaker drill ({plane}): the request after the drill missed the head")
    for h in handles:
        _stream_ended(plane, "breaker drill", h, tok.eos_id)
    decode_steps = _metric_delta(METRICS, trip["m"], "finchat_decode_dispatches_total")
    rounds = _metric_delta(METRICS, trip["m"], "finchat_mixed_dispatches_total")
    check_trip_launches(plane, spec, config, launches, counts, decode_steps, rounds)
    counts.close()
    if sched.session_cache.disk is not None:
        sched.session_cache.disk.close()
    checks = [teacher_forced_check(torch, params, config, _as_served(h, prompts[h.seq_id]),
                                   spec["kv_quant"]) for h in handles]
    sched.retire_prefixes()
    return dict(failed_rounds=failures, preemptions=preemptions, rebuilds=rebuilds,
                rebuild_s=rebuild_s, recovery_s=recovery_s, replay_ttft_s=replay_ttft,
                flight_dump=dict(events=len(box), dispatches=box_dispatches,
                                 bytes=dump_bytes),
                peak_above_held_gb=(peak - held) / 1e9, pool_gb=pool / 1e9,
                launches_after_trip={k: v for k, v in launches.items() if v},
                teacher_forced=checks)


async def _tokens_then(handle) -> dict:
    """Consume a handle's events to its terminal one, which it returns."""
    while True:
        event = await handle.events.get()
        if event["type"] != "token":
            return event


async def preemption_drill(torch, dev, plane: str, spec: dict, config, params, head_ids,
                           system_prompt: str, shared: int, disk_dir: str) -> dict:
    """Page-pressure preemption at full width on the serve's weights: a
    second engine whose pool holds the head's pages and two requests' own
    pages but not three. Two requests without a deadline stream; a third,
    with a deadline 60 s out, must preempt one of them; all three complete
    teacher-forced with exactly ``DRILL_NEW`` tokens or EOS. Then two more
    requests stream and ``shutdown_drain`` runs once each has a token: each
    ends with the ``shutting_down`` error, its history offloaded to the
    session tier, and no page is left but the head's."""
    import os

    from finchat_tpu_torch.engine.engine import InferenceEngine
    from finchat_tpu_torch.engine.kv_cache import pages_needed
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat
    from finchat_tpu_torch.utils.config import EngineConfig
    from finchat_tpu_torch.utils.metrics import METRICS

    tok = ByteTokenizer()
    page = EngineConfig().page_size
    prompts = [tok.encode(render_chat(system_prompt, CONTEXTS[i], [], MESSAGES[i]), add_bos=True)
               for i in range(3)]
    own = [pages_needed(len(p) + DRILL_NEW, page) - shared // page for p in prompts]
    num_pages = 1 + shared // page + sum(own) - 1  # two requests fit, three do not
    ecfg = EngineConfig(kv_quant=spec["kv_quant"], num_pages=num_pages,
                        session_cache_disk_path=os.path.join(disk_dir, "drill"))
    engine = InferenceEngine(config, params, ecfg, device=dev, quant=spec["quant"],
                             quant_group=spec["group"])
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    if sched.register_prefix(head_ids) != shared:
        fail(f"preemption drill ({plane}): the head did not register")
    log(f"  preemption drill ({plane}): a pool of {num_pages} pages (the head's "
        f"{shared // page}, own pages a request {own}); two requests, then one with a "
        "deadline 60 s out")
    greedy = SamplingParams(temperature=0.0, max_new_tokens=DRILL_NEW)
    m0 = METRICS.snapshot()
    await sched.start()
    try:
        first = [await sched.submit(f"pressure-{i}", prompts[i], greedy) for i in range(2)]
        ends = [asyncio.create_task(_tokens_then(h)) for h in first]
        while not all(h.generated >= 1 or h.finished for h in first):
            await asyncio.sleep(0.005)
        urgent = await sched.submit("pressure-urgent", prompts[2], greedy,
                                    deadline=time.perf_counter() + 60.0)
        ends.append(asyncio.create_task(_tokens_then(urgent)))
        events = await asyncio.gather(*ends)
        handles = first + [urgent]
        preemptions = _metric_delta(METRICS, m0, "finchat_preemptions_total")
        log(f"  preemption drill ({plane}): {preemptions:.0f} preemptions; preempted "
            f"{[h.preempted for h in handles]}; tokens {[h.generated for h in handles]}; "
            f"ends {[e.get('reason', e.get('message')) for e in events]}")
        if preemptions < 1:
            fail(f"preemption drill ({plane}): page pressure preempted nothing")
        if any(e["type"] != "done" for e in events):
            fail(f"preemption drill ({plane}): a stream failed: {events}")
        for h in handles:
            _stream_ended(plane, "preemption drill", h, tok.eos_id)
        # the shutdown drain: two more streams, drained once each has a token
        drain = [await sched.submit(f"drain-{i}", prompts[i], greedy,
                                    conversation_id=f"drain-{plane}-{i}") for i in range(2)]
        while not all(h.generated >= 1 for h in drain):
            await asyncio.sleep(0.005)
    finally:
        await sched.shutdown_drain()
    last = [await _tokens_then(h) for h in drain]
    disk = sched.session_cache.disk
    offloaded = [h.conversation_id in disk for h in drain]
    used = sched.allocator.used_count
    log(f"  shutdown drain ({plane}): errors {[e.get('code') for e in last]} after "
        f"{[h.generated for h in drain]} tokens; offloaded to the disk tier {offloaded}; "
        f"{used} pages left (the head's {shared // page})")
    want = {"type": "error", "message": "server shutting down; retry with backoff",
            "code": "shutting_down", "retryable": True}
    if any(e != want for e in last):
        fail(f"shutdown drain ({plane}): the stragglers ended with {last}")
    if not all(offloaded):
        fail(f"shutdown drain ({plane}): a straggler's history did not reach the session tier")
    if used != shared // page or sched.decoding or sched.prefilling or sched.pending:
        fail(f"shutdown drain ({plane}): {used} pages left, not the head's {shared // page}")
    disk.close()
    checks = [teacher_forced_check(torch, params, config, _as_served(h, prompts[i]),
                                   spec["kv_quant"]) for i, h in enumerate(handles)]
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    return dict(num_pages=num_pages, own_pages=own, preemptions=preemptions,
                preempted=[h.preempted for h in handles], teacher_forced=checks,
                drained_tokens=[h.generated for h in drain], pages_left=used)


# the agent's planes (grammar-constrained decode, partial holds): new tokens
# a stream, and the delay that stands in for a retrieval before the graft
AGENT_NEW = 64
RETRIEVAL_S = 0.2
# sat-out decode steps whose slots' pages are copied and compared whole (on
# every other one the slot's context length and last token are compared)
SAT_OUT_PAGE_CHECKS = 4


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def grammar_vocab(config, tok):
    """The tool grammar bound to the model's vocab through the reference's
    own constructor: ``ByteTokenizer``'s token texts, and an empty text (never
    allowed) for every id past them, so the masks are as wide as the head's
    logits rows."""
    from finchat_tpu_torch.agent.constrained import GrammarVocab, build_tool_grammar, token_texts

    texts = token_texts(tok)
    return GrammarVocab(build_tool_grammar(), texts + [""] * (config.vocab_size - len(texts)),
                        tok.eos_id)


def _page_tensors(engine) -> list:
    s = engine.state
    return [t for t in (s.k_pages, s.v_pages, s.k_scales, s.v_scales) if t is not None]


class _AgentProbe:
    """Instruments one scheduler for the constrained phase: which path each
    host pick took (the prefill round, the ragged round, a decode step's
    consume), the depth-2 dispatches a pending slot sat out and the depth-1
    dispatches (the loop's call of ``_dispatch_decode`` without
    ``exclude``), and around every decode step a slot sat out: its context
    length and last token unchanged, and for the first
    ``SAT_OUT_PAGE_CHECKS`` such steps every page of its context (K, V and
    scale planes) bit-identical across the step."""

    def __init__(self, torch, sched, engine):
        self.torch, self.sched, self.engine = torch, sched, engine
        self.where = [None]
        self.picks = {"prefill": 0, "ragged": 0, "decode": 0}
        self.sat_out_dispatches = self.depth1_dispatches = 0
        self.page_checks = self.scalar_checks = 0
        self.failures: list[str] = []

        def on(where, fn):
            async def wrapped(*a, **k):
                self.where[0] = where
                try:
                    return await fn(*a, **k)
                finally:
                    self.where[0] = None
            return wrapped

        sched._prefill_round = on("prefill", sched._prefill_round)
        sched._ragged_round = on("ragged", sched._ragged_round)
        sched._consume_step = on("decode", sched._consume_step)
        pick, dispatch, decode = sched._constrained_pick, sched._dispatch_decode, engine.decode

        def counting_pick(handle, row):
            self.picks[self.where[0]] += 1
            return pick(handle, row)

        def counting_dispatch(*a, **k):
            if not a and not k:
                self.depth1_dispatches += 1  # every decoding slot waited on a pick
            elif (a[0] if a else k["exclude"]):
                self.sat_out_dispatches += 1
            return dispatch(*a, **k)

        def checking_decode(active, *a, **k):
            out = [slot for slot in sched.decoding if not active[slot]]
            before = {}
            if out:
                _sync(torch)
                full = self.page_checks < SAT_OUT_PAGE_CHECKS
                for slot in out:
                    st = engine.state
                    ctx = int(st.context_lens[slot])
                    pages = sched.decoding[slot].page_list[: ctx // engine.page_size + 1]
                    idx = torch.tensor(pages, dtype=torch.long, device=st.k_pages.device)
                    before[slot] = (ctx, int(st.last_tokens[slot]), idx,
                                    [t[:, idx].clone() for t in _page_tensors(engine)]
                                    if full else None)
            result = decode(active, *a, **k)
            if out:
                _sync(torch)
                st = engine.state
                for slot, (ctx, last, idx, pages) in before.items():
                    if (int(st.context_lens[slot]), int(st.last_tokens[slot])) != (ctx, last):
                        self.failures.append(f"slot {slot} sat out a step and its context "
                                             f"length or last token moved")
                    if pages is not None and not all(
                            torch.equal(a_, t[:, idx]) for a_, t in zip(pages, _page_tensors(
                                engine))):
                        self.failures.append(f"slot {slot} sat out a step and a page of its "
                                             "context changed")
                    self.scalar_checks += 1
                if before[out[0]][3] is not None:
                    self.page_checks += 1
            return result

        sched._constrained_pick = counting_pick
        sched._dispatch_decode = counting_dispatch
        engine.decode = checking_decode

    def close(self) -> None:
        for name in ("_prefill_round", "_ragged_round", "_consume_step", "_constrained_pick",
                     "_dispatch_decode"):
            delattr(self.sched, name)
        del self.engine.decode


async def _run_to_end(handle) -> None:
    while True:
        event = await handle.events.get()
        if event["type"] == "done":
            return
        if event["type"] == "error":
            fail(f"{handle.seq_id}: {event['message']}")


def constrained_step_cost(torch, engine, vocab, context: int, active: int) -> dict:
    """What a constrained row adds to a decode step, on the engine's own
    state (random KV) at ``active`` slots of ``context`` tokens, host clock
    around work that ends in a synchronize: the decode step alone and the
    step with its logits and one row selected on the device and fetched, in
    turns, medians of 20 each; the fetch of one [vocab] fp32 row alone
    (median of 10); the host pick from it (the grammar's start state,
    median of 20; the first pick, which builds the state's mask, apart)."""
    import numpy as np

    from finchat_tpu_torch.agent.constrained import TokenConstraint

    B = engine.engine_cfg.max_seqs
    per = -(-(context + 8) // engine.page_size)
    engine.set_page_table_rows({s: list(range(1 + s * per, 1 + (s + 1) * per))
                                for s in range(active)})
    engine.set_context_lens_rows({s: context for s in range(active)})
    act = [s < active for s in range(B)]
    zeros, ones, izeros = [0.0] * B, [1.0] * B, [0] * B

    def once_ms(fn):
        t0 = time.perf_counter()
        fn()
        _sync(torch)
        return (time.perf_counter() - t0) * 1e3

    def median_ms(fn, n=10):
        fn()
        _sync(torch)
        return statistics.median(once_ms(fn) for _ in range(n))

    def plain():
        engine.decode(act, zeros, ones, izeros)

    rows = []

    def constrained():
        _tokens, logits = engine.decode(act, zeros, ones, izeros, return_logits=True)
        rows.append(engine.to_host(engine.select_rows(logits, [0])))

    # the host-bound step's time moves between steps: the two in turns
    # (plain, constrained, constrained, plain), medians of 20 each
    times: dict = {plain: [], constrained: []}
    for fn in (plain, constrained):
        fn()
    _sync(torch)
    for _ in range(10):
        for fn in (plain, constrained, constrained, plain):
            times[fn].append(once_ms(fn))
    plain_ms = statistics.median(times[plain])
    constrained_ms = statistics.median(times[constrained])
    row_dev = torch.randn((1, len(vocab.token_strs)), device=engine.device)
    fetch_ms = median_ms(lambda: engine.to_host(row_dev))
    row = rows[-1][0].astype(np.float32)
    rng = np.random.default_rng(0)
    vocab._mask_cache.pop(vocab.dfa.start, None)
    t0 = time.perf_counter()
    TokenConstraint(vocab).pick(row, 0.0, rng, remaining=AGENT_NEW)
    first_pick_ms = (time.perf_counter() - t0) * 1e3
    pick_ms = median_ms(lambda: TokenConstraint(vocab).pick(row, 0.0, rng, remaining=AGENT_NEW),
                        n=20)
    engine.reset_slots(list(range(active)))
    out = dict(active=active, context=context, decode_step_ms=plain_ms,
               decode_step_one_constrained_row_ms=constrained_ms, fetch_one_row_ms=fetch_ms,
               host_pick_ms=pick_ms, first_pick_ms=first_pick_ms)
    log(f"  constrained step cost: a decode step ({active} slots at {context} tokens) "
        f"{plain_ms:.3f} ms; with one constrained row (logits kept, the row selected on the "
        f"card and fetched) {constrained_ms:.3f} ms; the fetch of one row alone "
        f"{fetch_ms:.3f} ms; the host pick {pick_ms:.3f} ms (the first, building the state's "
        f"mask, {first_pick_ms:.3f} ms)")
    return out


async def agent_planes(torch, plane: str, spec: dict, config, engine, params, head_ids,
                       system_prompt: str, shared: int, partial: bool) -> dict:
    """The planes the agent rides on, at full width on the serve's engine and
    weights, on a scheduler of its own with the system head registered.

    Constrained decode: the tool grammar bound to the model's 128,256-wide
    vocab (``grammar_vocab``); four of the serve's requests run constrained
    (greedy, ``AGENT_NEW`` tokens at most) beside four plain ones: two plain
    and two constrained at once, two plain and one constrained once a first
    token streams, the last constrained one alone after them. Every path a
    constrained row takes must run (a pick in the prefill round, in the
    ragged round, at a decode step's consume; a constrained decode row of a
    ragged round; a depth-2 step a pending slot sat out; a depth-1 step),
    every constrained output must leave the grammar's DFA live or accepting
    and parse (``parse_tool_decision`` never raises), every plain stream pass
    the teacher-forced check and every constrained one the masked one, every
    page of a slot that sat out a step stay unchanged across it
    (``_AgentProbe``), and the window keep the serve's launch rules (the
    plane's Hopper bodies, no older one). Then ``constrained_step_cost``.

    Partial holds (with ``partial``): for two of the serve's prompts, a
    plain submit, then ``submit_partial`` of the rendered head plus context,
    parked, grafted by ``extend_prompt`` after ``RETRIEVAL_S``: the grafted
    stream must pass the teacher-forced check and ``finchat_partial_grafts_total``
    rise by one a graft; TTFT from the graft is printed beside the plain
    submit's. A divergent graft must return False, and its cancel give back
    every own page with the head's refcount unchanged."""
    from finchat_tpu_torch.agent.constrained import DEAD, TokenConstraint
    from finchat_tpu_torch.agent.toolcall import parse_tool_decision
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    tok = ByteTokenizer()
    t0 = time.perf_counter()
    vocab = grammar_vocab(config, tok)
    vocab_s = time.perf_counter() - t0
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    if sched.register_prefix(head_ids) != shared:
        fail(f"agent planes ({plane}): the head did not register")
    entry = sched._prefixes[0]
    head_pages = len(entry.pages)
    prompts = [tok.encode(render_chat(system_prompt, CONTEXTS[i], [], MESSAGES[i]), add_bos=True)
               for i in range(8)]
    plain_s = SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW)
    grammar_s = SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW, grammar="tool_call")
    log(f"  constrained decode ({plane}): the tool grammar bound to {len(vocab.token_strs)} "
        f"tokens in {vocab_s:.2f} s ({len(vocab.dfa.edges)} DFA states); 4 constrained and 4 "
        f"plain requests over the head, {AGENT_NEW} new tokens at most")
    counts = _Counts(engine)
    probe = _AgentProbe(torch, sched, engine)
    handles: dict[int, object] = {}

    async def run(i: int, constrained: bool):
        h = await sched.submit(f"{'grammar' if constrained else 'plain'}-{plane}-{i}",
                               prompts[i], grammar_s if constrained else plain_s,
                               constraint=TokenConstraint(vocab) if constrained else None)
        handles[i] = h
        await _run_to_end(h)

    constrained_ids = (2, 3, 5, 7)
    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    await sched.start()
    try:
        t_start = time.perf_counter()
        wave1 = [asyncio.create_task(run(i, i in constrained_ids)) for i in (0, 1, 2, 3)]
        while not any(h.generated > 0 for h in handles.values()):
            await asyncio.sleep(0.005)
        wave2 = [asyncio.create_task(run(i, i in constrained_ids)) for i in (4, 5, 6)]
        await asyncio.gather(*wave1, *wave2)
        await run(7, True)  # alone: the prefill round's pick and the depth-1 branch
        _sync(torch)
        wall = time.perf_counter() - t_start
    finally:
        await sched.stop()
    launches = dict(LAUNCHES)
    probe.close()
    ragged_constrained_rows = sum(
        1 for ev in TRACER.snapshot() if ev[2] == "dispatch" and ev[5]["kind"] == "ragged"
        for r in ev[5]["rows"] if r[2] == "constrained")
    outputs = {}
    for i in constrained_ids:
        h = handles[i]
        text = tok.decode([t for t in h.history[len(h.prompt_ids):] if t != tok.eos_id])
        state = vocab.dfa.step_string(vocab.dfa.start, text)
        try:
            call = parse_tool_decision(text)
        except Exception as e:
            fail(f"constrained decode ({plane}): parse_tool_decision raised {e!r} on {text!r}")
        if state == DEAD:
            fail(f"constrained decode ({plane}): {h.seq_id} left the grammar: {text!r}")
        outputs[h.seq_id] = dict(text=text, tokens=h.generated,
                                 accepting=bool(vocab.dfa.eos_ok[state]),
                                 call=None if call is None else [call.name, call.args])
    log(f"  constrained decode ({plane}): 8 streams in {wall:.2f} s; outputs "
        + json.dumps(outputs))
    log(f"  constrained decode ({plane}): picks by path {probe.picks}; constrained decode rows "
        f"in ragged rounds {ragged_constrained_rows}; depth-2 steps a pending slot sat out "
        f"{probe.sat_out_dispatches}, depth-1 steps {probe.depth1_dispatches}; sat-out slots "
        f"checked {probe.scalar_checks} (context and last token), {probe.page_checks} steps "
        "with every page compared")
    if probe.failures:
        fail(f"constrained decode ({plane}): {probe.failures[:4]}")
    if (min(probe.picks.values()) < 1 or ragged_constrained_rows < 1
            or probe.sat_out_dispatches < 1 or probe.depth1_dispatches < 1
            or probe.page_checks < 1):
        fail(f"constrained decode ({plane}): a path of the constrained rows did not run")
    for h in handles.values():
        _stream_ended(plane, "constrained decode", h, tok.eos_id)
    decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
    rounds = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
    missing = [k for k in spec["kernels"] if launches[k] == 0]
    if missing:
        fail(f"constrained decode ({plane}): kernels not launched: {missing}")
    check_window(plane, "constrained decode", spec, config, launches, counts, decode_steps,
                 rounds)
    checks = [teacher_forced_check(torch, params, config, handles[i], spec["kv_quant"],
                                   vocab=vocab if i in constrained_ids else None)
              for i in sorted(handles)]
    cost = constrained_step_cost(torch, engine, vocab, SERVE_CONTEXT, 8)
    out = dict(wall_s=wall, vocab_build_s=vocab_s, outputs=outputs, picks=probe.picks,
               ragged_constrained_rows=ragged_constrained_rows,
               sat_out_dispatches=probe.sat_out_dispatches,
               depth1_dispatches=probe.depth1_dispatches, page_checks=probe.page_checks,
               scalar_checks=probe.scalar_checks, teacher_forced=checks, step_cost=cost,
               launches={k: v for k, v in launches.items() if v})
    if partial:
        out["partial"] = await partial_holds(torch, plane, spec, config, params, sched, entry,
                                             head_pages, system_prompt)
    counts.close()
    sched.retire_prefixes()
    if sched.allocator.used_count != 0:
        fail(f"agent planes ({plane}): {sched.allocator.used_count} KV pages still allocated")
    if sched.session_cache is not None and sched.session_cache.disk is not None:
        sched.session_cache.disk.close()
    return out


async def partial_holds(torch, plane, spec, config, params, sched, entry, head_pages: int,
                        system_prompt: str) -> dict:
    """The retrieval overlap at full width (see ``agent_planes``)."""
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer, render_chat, render_chat_prefix
    from finchat_tpu_torch.utils.metrics import METRICS

    tok = ByteTokenizer()
    greedy = SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW)
    rows = []
    checks = []
    await sched.start()
    try:
        for i in (0, 1):
            full = tok.encode(render_chat(system_prompt, CONTEXTS[i], [], MESSAGES[i]),
                              add_bos=True)
            # the prefix as the generator takes it: BOS added, the last token
            # dropped (it could merge across the graft)
            prefix = tok.encode(render_chat_prefix(system_prompt, CONTEXTS[i], []),
                                add_bos=True)[:-1]
            if full[: len(prefix)] != prefix:
                fail(f"partial holds ({plane}): the rendered prefix does not lead the prompt")
            plain = await sched.submit(f"plain-{plane}-p{i}", full, greedy)
            await _run_to_end(plain)
            g0 = METRICS.get("finchat_partial_grafts_total")
            hold = await sched.submit_partial(f"hold-{plane}-{i}", prefix, greedy)
            if hold is None:
                fail(f"partial holds ({plane}): submit_partial refused the prefix")
            t_park = time.perf_counter()
            while not (hold.slot >= 0 and hold.prefill_pos >= len(hold.prompt_ids)):
                await asyncio.sleep(0.002)
            parked_s = time.perf_counter() - t_park
            await asyncio.sleep(RETRIEVAL_S)  # the retrieval
            t_graft = time.perf_counter()
            if not sched.extend_prompt(hold, full):
                fail(f"partial holds ({plane}): the graft was refused")
            graft_host_s = time.perf_counter() - t_graft
            await _run_to_end(hold)
            grafts = METRICS.get("finchat_partial_grafts_total") - g0
            row = dict(prompt_tokens=len(full), prefix_tokens=len(prefix),
                       shared=hold.shared_len, parked_after_s=parked_s,
                       graft_host_s=graft_host_s,
                       ttft_from_graft_s=hold.first_token_at - t_graft,
                       plain_ttft_s=plain.first_token_at - plain.submitted_at,
                       grafts=grafts, same_tokens_as_plain=hold.history == plain.history)
            log(f"  partial hold {i} ({plane}): prompt {len(full)} tokens, prefix {len(prefix)} "
                f"({hold.shared_len} on the head) parked {parked_s:.3f} s after submit; graft "
                f"{graft_host_s * 1e3:.3f} ms on the host; TTFT from the graft "
                f"{row['ttft_from_graft_s']:.3f} s against a plain submit's "
                f"{row['plain_ttft_s']:.3f} s; grafts +{grafts:.0f}; tokens equal the plain "
                f"submit's: {row['same_tokens_as_plain']}")
            if grafts != 1 or not hold.grafted:
                fail(f"partial holds ({plane}): finchat_partial_grafts_total rose by {grafts}")
            checks.append(teacher_forced_check(torch, params, config, hold, spec["kv_quant"]))
            rows.append(row)
        # a divergent graft: refused, and its cancel gives every own page back
        prefix = tok.encode(render_chat_prefix(system_prompt, CONTEXTS[2], []), add_bos=True)[:-1]
        refs0, used0 = entry.refs, sched.allocator.used_count
        hold = await sched.submit_partial(f"diverge-{plane}", prefix, greedy)
        while not (hold.slot >= 0 and hold.prefill_pos >= len(hold.prompt_ids)):
            await asyncio.sleep(0.002)
        own = len(sched.allocator.owned_by(hold.seq_id))
        refused = not sched.extend_prompt(hold, [tok.bos_id] + prefix + [65])
        sched.cancel(hold)
        left = len(sched.allocator.owned_by(hold.seq_id))
        log(f"  divergent graft ({plane}): refused {refused}; the hold owned {own} pages, "
            f"{left} after its cancel; the head's refcount {refs0} -> {entry.refs}; "
            f"{sched.allocator.used_count} pages allocated (before it {used0}, the head's "
            f"{head_pages})")
        if not refused or left or entry.refs != refs0 or sched.allocator.used_count != used0:
            fail(f"partial holds ({plane}): the divergent graft leaked or was taken")
    finally:
        await sched.stop()
    return dict(holds=rows, teacher_forced=checks, divergent_own_pages=own)


# the agent's turns (``agent_turns``): new tokens at most for the decision (the
# response takes ``AGENT_NEW``), the fake retriever's rows (after
# ``RETRIEVAL_S``), the date the prompts carry, and the stub decision of the
# overlap comparison, paced a word every ``STUB_WORD_S`` (its search query
# commits on the second word)
DECISION_NEW = 96
TURN_ROWS = [
    "2026-07-30 COFFEE CORNER -4.50 dining",
    "2026-07-29 FRESH MARKET -86.12 groceries",
    "2026-07-28 CITY TRANSIT -2.75 transport",
    "2026-07-27 NOODLE BAR -23.40 dining",
    "2026-07-25 PAYROLL +3100.00 income",
    "2026-07-24 STREAMING CO -15.99 subscriptions",
    "2026-07-21 FRESH MARKET -64.30 groceries",
    "2026-07-01 LANDLORD LLC -1850.00 rent",
]
AGENT_DAY = "2026-08-03"
STUB_DECISION = 'retrieve_transactions({"search_query": "dining", "num_transactions": 20})'
STUB_WORD_S = 0.1


class _TurnRetriever:
    """The agent's fake retriever: ``RETRIEVAL_S`` of latency, then
    ``TURN_ROWS``. With ``structured`` (given only where matplotlib is
    installed) it also serves a plot call's rows, each with an amount."""

    def __init__(self, structured: bool):
        self.calls: list[dict] = []
        if structured:
            self.structured = self._structured

    async def __call__(self, args):
        self.calls.append(dict(args))
        await asyncio.sleep(RETRIEVAL_S)
        return list(TURN_ROWS)

    async def _structured(self, args):
        self.calls.append(dict(args))
        await asyncio.sleep(RETRIEVAL_S)
        return [dict(page_content=row, amount=float(i + 1), date=float(i))
                for i, row in enumerate(TURN_ROWS)]


def check_turn_protocol(plane: str, what: str, events: list) -> tuple[bool, int]:
    """One ``stream_with_status`` turn against the reference's protocol: the
    two opening statuses; then the retrieval status, ``retrieval_complete``
    (and a plot event where a chart was drawn), or the no-retrieval status;
    then "Generating response...", only response chunks, and ``complete``.
    Returns whether the turn retrieved, and its row count."""
    status = [{"type": "status", "message": m} for m in (
        "Starting query processing...",
        "Analyzing query to determine if transaction data is needed...",
        "Retrieving relevant transaction data...", "No transaction data retrieval needed",
        "Generating response...")]
    complete = {"type": "complete", "message": "Query processing completed"}
    ok = events[:2] == status[:2] and status[4] in events and events[-1] == complete
    retrieved, count = False, 0
    if ok:
        g = events.index(status[4])
        middle = events[2:g]
        ok = all(e["type"] == "response_chunk" and e["content"] for e in events[g + 1:-1])
        retrieved = bool(middle) and middle[0] == status[2]
        if retrieved:
            rc = middle[1] if len(middle) > 1 else {}
            count = rc.get("count", -1)
            plot = middle[2:]
            ok = ok and rc == {"type": "retrieval_complete", "count": count,
                               "message": f"Retrieved {count} transactions"} and (
                not plot or (len(plot) == 1 and plot[0]["type"] == "plot"
                             and plot[0]["data_uri"].startswith("data:image/png;base64,")))
        else:
            ok = ok and middle == [status[3]]
    if not ok:
        fail(f"agent turns ({plane}, {what}): the events break the protocol: "
             + json.dumps([e if e["type"] != "plot" else {"type": "plot"} for e in events])[:2000])
    return retrieved, count


def _turn_handles(handles, conv: str) -> tuple:
    """The decision handle and the response handle (the grafted hold, or the
    plain submit) of the turn of ``conv``, by their session keys."""
    tool = [h for h in handles if h.conversation_id == f"{conv}#tool"]
    resp = [h for h in handles if h.conversation_id == f"{conv}#resp"]
    return (tool[-1] if tool else None), (resp[-1] if resp else None), resp


def _marks(tracer, trace_id: str) -> dict:
    """The agent's marks of one turn on the trace: name -> first ts."""
    out = {}
    for ev in tracer.snapshot():
        if ev[1] == trace_id and ev[2] not in out:
            out[ev[2]] = ev[0]
    return out


def _wait_for(cond, what: str, limit_s: float = 10.0):
    async def waiter():
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > limit_s:
                fail(what)
            await asyncio.sleep(0.005)
    return waiter()


async def agent_turns(torch, plane: str, spec: dict, config, engine, params, system_prompt: str,
                      pairs: int, overlap_runs: bool) -> dict:
    """Penny turns through the port's ``LLMAgent`` at full width, on the
    serve's engine and weights, on a scheduler of its own at
    ``EngineConfig()`` with both ``agent.prompt_heads()`` registered (BOS
    added, the last token dropped, as the app registers them). The prompts
    are the repo's ``prompts/``; everything is greedy, at most
    ``DECISION_NEW`` tokens for the decision and ``AGENT_NEW`` for the
    response; every turn is its own conversation and user, traced.

    1. Engine-decided: both roles are one ``EngineGenerator`` over the model,
       whose ``ByteTokenizer`` is as wide as the logits rows (its texts past
       the bytes are empty), so the decision's ``tool_call`` grammar binds to
       all 128,256 ids. ``pairs`` pairs of turns, two at a time, over the fake
       retriever. Each turn's events must follow the reference's protocol;
       the decision text must leave the DFA accepting, and the streamed
       parser (recorded) must end with no anomaly and agree with
       ``parse_tool_decision``; the decision passes the teacher-forced check
       under its grammar mask, the response the plain one;
       ``finchat_partial_grafts_total`` must rise by one a turn that
       retrieved (the hold taken at name-commit, before the decision's last
       token) and the pages after the turns equal those before.
    2. With ``overlap_runs``: the decision from a ``StubGenerator`` paced a
       word every ``STUB_WORD_S`` whose search query commits on its second
       word, the response on the engine; the same two turns with
       ``retrieval_overlap`` and ``tool_streaming`` on, then both off. The
       responses must be byte-identical; with them on, the tool must launch
       once a turn and be adopted (no cancel, no fallback, the
       ``tool_adopted`` mark), the hold taken at name-commit (the
       ``name_commit`` then ``response_prefill_hold`` marks, before the
       stub's decode ended) and grafted; with them off, nothing launches or
       holds. Every response of both runs passes the teacher-forced check. The response TTFT from the turn's start, on and off, and
       ``finchat_tool_overlap_saved_seconds`` are printed.
    3. With ``overlap_runs``: an abandoned turn. Its consumer goes away once
       the response has its first token (the task iterating
       ``stream_with_status`` is cancelled, as a client disconnect does, and
       the generator closed): no hold, slot or own page may be left, and
       the heads' refcounts must be as before.

    Launch counts are set to 0 after the registrations and read after part
    2: every kernel of the plane must have launched, under the serve's launch
    rules (``check_window``)."""
    import importlib.util

    import finchat_tpu_torch.agent.graph as graph_mod
    from finchat_tpu_torch.agent import LLMAgent
    from finchat_tpu_torch.agent.constrained import DEAD
    from finchat_tpu_torch.agent.toolcall import parse_tool_decision
    from finchat_tpu_torch.engine.generator import EngineGenerator, StubGenerator
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from finchat_tpu_torch.models.tokenizer import ByteTokenizer
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    matplotlib = importlib.util.find_spec("matplotlib") is not None
    tok = ByteTokenizer(vocab_size=config.vocab_size)
    tool_prompt = (REPO / "prompts" / "tool_prompt.txt").read_text()
    sched = ContinuousBatchingScheduler(engine, tok.eos_id)
    gen = EngineGenerator(sched, tok)
    handles: list = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    decision_s = SamplingParams(temperature=0.0, max_new_tokens=DECISION_NEW, grammar="tool_call")
    response_s = SamplingParams(temperature=0.0, max_new_tokens=AGENT_NEW)

    def make_agent(tool_gen, retriever, on: bool = True):
        return LLMAgent(tool_gen, gen, retriever, system_prompt, tool_prompt,
                        tool_sampling=decision_s, response_sampling=response_s,
                        today=lambda: AGENT_DAY, retrieval_overlap=on, tool_streaming=on)

    heads = make_agent(gen, None).prompt_heads()
    shared = [sched.register_prefix(tok.encode(head, add_bos=True)[:-1]) for head in heads]
    if not all(shared) or len(sched._prefixes) != 2:
        fail(f"agent turns ({plane}): the two prompt heads registered {shared}")
    entries = list(sched._prefixes)
    head_pages = sum(len(e.pages) for e in entries)
    log(f"  agent turns ({plane}): prompt heads of {shared} shared tokens ({head_pages} pages) "
        f"registered; matplotlib on this machine: {matplotlib} (the fake retriever "
        f"{'serves' if matplotlib else 'has no'} structured rows for a plot call)")
    parsers: list = []
    base_parser = graph_mod.StreamingToolParser

    class RecordingParser(base_parser):
        """The agent's streaming parser, kept for the checks."""

        def __init__(self):
            super().__init__()
            self.final = "unfinished"
            parsers.append(self)

        def finish(self):
            self.final = super().finish()
            return self.final

    async def turn(agent, i: int, conv: str) -> dict:
        t0 = time.perf_counter()
        events = [ev async for ev in agent.stream_with_status(
            MESSAGES[i], f"user-{conv}", CONTEXTS[i], [], conversation_id=conv, trace_id=conv)]
        return dict(conv=conv, i=i, t0=t0, events=events)

    counts = _Counts(engine)
    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    graph_mod.StreamingToolParser = RecordingParser
    out: dict = dict(matplotlib=matplotlib, shared=shared)
    t_phase = time.perf_counter()
    await sched.start()
    try:
        # 1. engine-decided turns, two at a time
        used0 = sched.allocator.used_count
        g0 = METRICS.get("finchat_partial_grafts_total")
        retriever = _TurnRetriever(structured=matplotlib)
        agent = make_agent(gen, retriever)
        if agent.metrics is not sched.metrics:
            fail(f"agent turns ({plane}): the agent's registry is not its scheduler's")
        t_start = time.perf_counter()
        turns = []
        for p in range(pairs):
            turns += await asyncio.gather(*(turn(agent, i, f"agent-{plane}-{i}")
                                            for i in (2 * p, 2 * p + 1)))
        _sync(torch)
        wall = time.perf_counter() - t_start
        await _wait_for(lambda: sched.allocator.used_count == used0 and not sched.decoding
                        and not sched.prefilling,
                        f"agent turns ({plane}): {sched.allocator.used_count} pages allocated "
                        f"after the turns, not the heads' {used0}")
        grafts = METRICS.get("finchat_partial_grafts_total") - g0
        vocab = await gen._grammar_vocabs["tool_call"]
        if len(vocab.token_strs) != config.vocab_size:
            fail(f"agent turns ({plane}): the grammar is {len(vocab.token_strs)} ids wide")
        rows, checks, n_retrieved = [], [], 0
        for t in turns:
            retrieved, count = check_turn_protocol(plane, t["conv"], t["events"])
            decision, response, _all = _turn_handles(handles, t["conv"])
            if decision is None or response is None:
                fail(f"agent turns ({plane}): {t['conv']} has no decision or response handle")
            _stream_ended(plane, "agent turns", decision, tok.eos_id)
            _stream_ended(plane, "agent turns", response, tok.eos_id)
            text = tok.decode([x for x in decision.history[len(decision.prompt_ids):]
                               if x != tok.eos_id])
            state = vocab.dfa.step_string(vocab.dfa.start, text)
            if state == DEAD or not vocab.dfa.eos_ok[state]:
                fail(f"agent turns ({plane}): {t['conv']}'s decision leaves the grammar "
                     f"unaccepted: {text!r}")
            call = parse_tool_decision(text)
            if (call is not None) != retrieved:
                fail(f"agent turns ({plane}): {t['conv']} retrieved {retrieved}, its decision "
                     f"parses to {call}")
            n_retrieved += retrieved
            hold_lead = None
            if retrieved:
                # the hold submitted at name-commit, before the decision's last token
                marks = _marks(TRACER, t["conv"])
                if not (response.grafted and "name_commit" in marks
                        and "response_prefill_hold" in marks
                        and response.submitted_at < decision.last_token_at):
                    fail(f"agent turns ({plane}): {t['conv']}'s response hold was not taken "
                         f"at name-commit and grafted: marks {sorted(marks)}")
                hold_lead = decision.last_token_at - response.submitted_at
            checks.append(teacher_forced_check(torch, params, config, decision,
                                               spec["kv_quant"], vocab=vocab))
            checks.append(teacher_forced_check(torch, params, config, response,
                                               spec["kv_quant"]))
            ttft = response.first_token_at - t["t0"]
            rows.append(dict(conv=t["conv"], decision=text, decision_tokens=decision.generated,
                             decision_s=decision.last_token_at - decision.submitted_at,
                             call=None if call is None else [call.name, call.args],
                             retrieved=retrieved, rows=count, hold_lead_s=hold_lead,
                             grafted=response.grafted, response_tokens=response.generated,
                             ttft_from_turn_start_s=ttft,
                             chunks=sum(e["type"] == "response_chunk" for e in t["events"])))
            log(f"  agent turn {t['conv']} ({plane}): decision {decision.generated} tokens in "
                f"{rows[-1]['decision_s']:.3f} s: {text!r}; retrieved {retrieved} ({count} rows)"
                + (f"; hold taken {hold_lead:.3f} s before the decision's last token, grafted"
                   if retrieved else "")
                + f"; response {response.generated} tokens, {rows[-1]['chunks']} text chunks, "
                f"TTFT from the turn's start {ttft:.3f} s")
        recorded = sorted((p.text, repr(p.final), p.anomaly) for p in parsers)
        want = sorted((r["decision"], repr(parse_tool_decision(r["decision"])), None)
                      for r in rows)
        if recorded != want or any(p.completed_call is not None and p.completed_call != p.final
                                   for p in parsers):
            fail(f"agent turns ({plane}): the streamed parsers {recorded} do not agree with "
                 f"parse_tool_decision over the decisions {want}")
        log(f"  agent turns ({plane}): {len(turns)} engine-decided turns in {wall:.2f} s; "
            f"{n_retrieved} retrieved, partial grafts +{grafts:.0f}; pages after the turns "
            f"{sched.allocator.used_count} (before {used0}); the streamed parsers agree with "
            "parse_tool_decision")
        if grafts != n_retrieved:
            fail(f"agent turns ({plane}): finchat_partial_grafts_total rose by {grafts}, "
                 f"{n_retrieved} turns retrieved")
        out.update(engine_turns=rows, engine_wall_s=wall, grafts=grafts, teacher_forced=checks)
        if overlap_runs:
            out["overlap"] = await _overlap_runs(torch, plane, spec, config, params, sched,
                                                 handles, turn, make_agent, StubGenerator)
        launches = dict(LAUNCHES)
        decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
        rounds = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
        missing = [k for k in spec["kernels"] if launches[k] == 0]
        if missing:
            fail(f"agent turns ({plane}): kernels not launched: {missing}")
        check_window(plane, "agent turns", spec, config, launches, counts, decode_steps, rounds)
        out["launches"] = {k: v for k, v in launches.items() if v}
        if overlap_runs:
            out["abandoned"] = await _abandoned_turn(plane, sched, handles, entries, make_agent,
                                                     StubGenerator)
    finally:
        graph_mod.StreamingToolParser = base_parser
        await sched.stop()
        sched.submit = submit
        counts.close()
    sched.retire_prefixes()
    if sched.allocator.used_count != 0:
        fail(f"agent turns ({plane}): {sched.allocator.used_count} KV pages still allocated")
    if sched.session_cache is not None and sched.session_cache.disk is not None:
        sched.session_cache.disk.close()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  agent turns ({plane}): the phase took {out['phase_s']:.1f} s")
    return out


def _paced_stub(stub_cls):
    """A ``StubGenerator`` decision paced a word every ``STUB_WORD_S``; its
    ``ended`` lists when each of its streams ended (the decode's end)."""

    class Paced(stub_cls):
        def __init__(self):
            super().__init__(default=STUB_DECISION, chunk_delay=STUB_WORD_S)
            self.ended: list[float] = []

        async def stream(self, *a, **k):
            async for piece in super().stream(*a, **k):
                yield piece
            self.ended.append(time.perf_counter())

    return Paced()


async def _overlap_runs(torch, plane, spec, config, params, sched, handles, turn, make_agent,
                        stub_cls) -> dict:
    """Part 2 of ``agent_turns``: the same two turns with the overlap and tool
    streaming on, then off."""
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    counters = ("finchat_tool_launches_total", "finchat_tool_speculative_cancels_total",
                "finchat_tool_fallbacks_total", "finchat_partial_holds_total",
                "finchat_partial_grafts_total")
    runs = {}
    for on in (True, False):
        m0 = METRICS.snapshot()
        stub = _paced_stub(stub_cls)
        agent = make_agent(stub, _TurnRetriever(structured=False), on=on)
        name = "on" if on else "off"
        turns = await asyncio.gather(*(turn(agent, i, f"stub-{plane}-{name}-{i}")
                                       for i in (0, 1)))
        delta = {c: _metric_delta(METRICS, m0, c) for c in counters}
        saved = _seconds(METRICS, m0, "finchat_tool_overlap_saved_seconds")
        rows = []
        for t in turns:
            retrieved, count = check_turn_protocol(plane, t["conv"], t["events"])
            _d, response, _all = _turn_handles(handles, t["conv"])
            if not retrieved or response is None:
                fail(f"agent turns ({plane}): the stub turn {t['conv']} did not retrieve")
            marks = _marks(TRACER, t["conv"])
            text = "".join(e["content"] for e in t["events"] if e["type"] == "response_chunk")
            rows.append(dict(conv=t["conv"], text=text, rows=count,
                             tokens=response.history[len(response.prompt_ids):],
                             grafted=response.grafted, ttft_s=response.first_token_at - t["t0"],
                             marks={k: v - t["t0"] for k, v in marks.items()}))
            if on:
                ok = (response.grafted and "tool_adopted" in marks and "tool_launch" in marks
                      and marks.get("name_commit", 1e18) <= marks.get("response_prefill_hold", 0)
                      < min(e for e in stub.ended if e > t["t0"]))
            else:
                ok = not response.grafted and not ({"tool_launch", "response_prefill_hold"}
                                                   & set(marks))
            if not ok:
                fail(f"agent turns ({plane}): overlap {name}: {t['conv']}'s marks "
                     f"{rows[-1]['marks']} (grafted {response.grafted})")
        checks = [teacher_forced_check(torch, params, config, _turn_handles(handles, t["conv"])[1],
                                       spec["kv_quant"]) for t in turns]
        want = (dict(finchat_tool_launches_total=2, finchat_tool_speculative_cancels_total=0,
                     finchat_tool_fallbacks_total=0, finchat_partial_holds_total=2,
                     finchat_partial_grafts_total=2) if on else {c: 0 for c in counters})
        if delta != want or saved["n"] != (2 if on else 0):
            fail(f"agent turns ({plane}): overlap {name}: counters {delta}, overlap-saved "
                 f"observations {saved['n']} (want {want}, {2 if on else 0})")
        runs[name] = dict(turns=rows, counters=delta, overlap_saved=saved, teacher_forced=checks)
        log(f"  agent overlap {name} ({plane}): response TTFT from the turn's start "
            + ", ".join(f"{r['ttft_s']:.3f}" for r in rows) + " s; marks (s from the turn's "
            "start) " + json.dumps([{k: round(v, 4) for k, v in r["marks"].items()
                                     if k != "dispatch"} for r in rows])
            + f"; counters {delta}; finchat_tool_overlap_saved_seconds {saved['n']} "
            f"observations, {saved['total_s']:.3f} s in all")
    same_text = [a["text"] == b["text"] for a, b in zip(runs["on"]["turns"], runs["off"]["turns"])]
    same_tokens = [a["tokens"] == b["tokens"]
                   for a, b in zip(runs["on"]["turns"], runs["off"]["turns"])]
    # where the greedy ids part (both streams passed the teacher-forced check)
    first_diff = [next((k for k, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y),
                       None) for a, b in zip(runs["on"]["turns"], runs["off"]["turns"])]
    log(f"  agent overlap ({plane}): responses byte-identical on and off: {same_text}; token "
        f"ids identical: {same_tokens} (first different id at {first_diff})")
    if not all(same_text):
        fail(f"agent turns ({plane}): the responses differ with the overlap on and off")
    for run in runs.values():
        for r in run["turns"]:
            r.pop("tokens")
    return dict(runs=runs, byte_identical=same_text, token_identical=same_tokens,
                first_different_id=first_diff)


async def _abandoned_turn(plane, sched, handles, entries, make_agent, stub_cls) -> dict:
    """Part 3 of ``agent_turns``: a turn whose consumer goes away once the
    response has its first token."""
    free0, used0 = len(sched.free_slots), sched.allocator.used_count
    refs0 = [e.refs for e in entries]
    conv = f"abandoned-{plane}"
    agent = make_agent(stub_cls(default=STUB_DECISION), _TurnRetriever(structured=False))
    stream = agent.stream_with_status(MESSAGES[3], "user-abandoned", CONTEXTS[3], [],
                                      conversation_id=conv)
    seen: list = []

    async def consume():
        async for ev in stream:
            seen.append(ev["type"])

    task = asyncio.create_task(consume())

    def started():
        _d, response, _all = _turn_handles(handles, conv)
        return task.done() or (response is not None and response.generated >= 1)

    await _wait_for(started, f"agent turns ({plane}): the abandoned turn's response never "
                             "started")
    if task.done():
        fail(f"agent turns ({plane}): the abandoned turn ended before it was abandoned: {seen}")
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass
    await stream.aclose()
    _d, response, mine = _turn_handles(handles, conv)
    await _wait_for(lambda: all(h.finished for h in mine) and not sched.decoding
                    and not sched.prefilling and not sched.pending
                    and sched.allocator.used_count == used0,
                    f"agent turns ({plane}): the abandoned turn left work or pages: "
                    f"{sched.allocator.used_count} pages (before {used0})")
    own = sum(len(sched.allocator.owned_by(h.seq_id)) for h in mine)
    refs = [e.refs for e in entries]
    held = [h.seq_id for h in mine if h.held]
    log(f"  agent abandoned turn ({plane}): consumer cancelled after {seen} with the response at "
        f"{response.generated} tokens (grafted {response.grafted}); {len(mine)} handles, all "
        f"finished, {own} own pages, {len(held)} holds left; free slots {len(sched.free_slots)} "
        f"(before {free0}); the heads' refcounts {refs0} -> {refs}; {sched.allocator.used_count} "
        f"pages allocated (before {used0})")
    if own or held or refs != refs0 or len(sched.free_slots) != free0 or not response.grafted:
        fail(f"agent turns ({plane}): the abandoned turn leaked a hold, slot, page or head "
             "reference")
    return dict(events_seen=seen, response_tokens=response.generated, own_pages=own,
                refs=refs)


# the app's turns (``app_turns``): four conversations over the in-memory
# broker and store, turn 2 of two of them, a redelivery, one HTTP turn
APP_CONVS = 4
APP_TURN2 = 2
APP_WAIT_S = 300.0


def _app_context(i: int) -> dict:
    """A conversation's stored context document (``render_context`` gives
    the prompt's context block): a few accounts and expenses, so the
    context runs past the head's last page and a second turn has whole
    pages of its own to resume."""
    return {
        "user_id": f"user-app-{i}", "name": f"Member {i}", "income": 5200 + 100 * i,
        "savings_goal": 600 + 25 * i,
        "accounts": [{"official_name": f"Everyday Checking {k}",
                      "balances": {"current": 1234.5 + 10 * k, "iso_currency_code": "USD"}}
                     for k in range(4)],
        "additional_monthly_expenses": [
            {"name": name, "amount": amount, "description": desc}
            for name, amount, desc in (("Rent", 1850, "downtown apartment"), ("Gym", 40, ""),
                                       ("Car loan", 412, "9,800 at 6.9% APR"),
                                       ("Streaming", 16, "two services"))],
    }


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, path: str, body: dict | None = None,
          headers: dict | None = None) -> tuple[int, str, str]:
    """One request over a real socket with the stdlib (the card's machine
    has no HTTP client package): (status, content type, body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=APP_WAIT_S)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read().decode()
    finally:
        conn.close()


def _prometheus_families(text: str) -> set:
    """The families of a Prometheus text exposition, each line checked: a
    ``# TYPE`` / ``# exemplar`` comment or a ``name{labels} value`` sample
    with a float value. Fails on a line that is neither."""
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')
    families = set()
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# exemplar "):
            continue
        if line.startswith("# TYPE "):
            families.add(line.split(" ")[2])
            continue
        m = sample.match(line)
        if m is None:
            fail(f"app turns: /metrics line is not Prometheus text: {line!r}")
        float(m.group(3))
    return families


def _check_chunks(what: str, raw: list, payloads: dict) -> dict:
    """Every outbound record of ``ai_response`` parses and follows the
    reference protocol: response chunks (``last_message`` false, ``error``
    false, sender ``AIMessage``, every inbound field passed through), then
    one ``complete`` marker carrying the original user text; an error chunk
    (no ``type``) fails the phase. Returns message_id -> the concatenated
    response text."""
    texts: dict = {}
    completes: dict = {}
    for value in raw:
        chunk = json.loads(value)
        mid = chunk.get("message_id")
        if mid not in payloads:
            fail(f"app turns ({what}): an outbound record of no inbound message: {chunk}")
        inbound = payloads[mid]
        if "type" not in chunk or chunk.get("error") is not False:
            fail(f"app turns ({what}): an error chunk for {mid}: {chunk}")
        if completes.get(mid):
            fail(f"app turns ({what}): a record after {mid}'s complete marker: {chunk}")
        passthrough = all(chunk.get(k) == v for k, v in inbound.items() if k != "message")
        if chunk["type"] == "response_chunk":
            ok = (chunk["last_message"] is False and chunk["sender"] == "AIMessage"
                  and isinstance(chunk["message"], str) and passthrough)
            texts[mid] = texts.get(mid, "") + chunk["message"]
        elif chunk["type"] == "complete":
            ok = (chunk["last_message"] is True and chunk["sender"] == "AIMessage"
                  and chunk["message"] == inbound["message"] and passthrough)
            completes[mid] = True
        else:
            ok = chunk["type"] == "plot" and chunk["message"].startswith("data:image/png")
        if not ok:
            fail(f"app turns ({what}): a record breaks the chunk protocol: {chunk}")
    missing = [mid for mid in payloads if mid not in completes]
    if missing:
        fail(f"app turns ({what}): no complete marker for {missing}")
    return {mid: texts.get(mid, "") for mid in payloads}


async def app_turns(torch, dev, card: str) -> dict:
    """Penny turns through the port's serving app at ``llama3-8b``'s full
    width, bf16: ``build_app`` itself builds the model (random weights from
    ``model.seed``, its ``ByteTokenizer`` as wide as the logits rows), the
    engine at ``EngineConfig()``'s defaults, warmed up, and registers both
    prompt heads; an ``InMemoryStore`` holds four conversations, a
    ``KafkaClient`` rides an ``InMemoryBroker``, the retriever is
    ``agent_turns``' fake one. Sampling is greedy (``engine.temperature``
    0, the agent's decision greedy under its grammar) so every stream can be
    teacher-forced; ``engine.max_new_tokens`` is 64, ``kafka.
    commit_after_process`` on, the session disk tier, journal and flight
    recorder in a temporary directory.

    Driven through the consume loop (``app.start(serve_http=True)``): four
    user messages produced at once, then a second turn of two
    conversations (resumed through the session cache), then one answered
    message redelivered (deduped: nothing produced, the skip counter up by
    one). Over HTTP from a worker thread: ``/health``, one
    ``/chat/stream`` turn (the reference's SSE event order), ``/metrics``
    (Prometheus text with ``finchat_ttft_seconds`` and the Kafka families)
    and ``/debug/trace/<message_id>`` (the message's ingress event and
    first token). Last ``drain_and_stop()``: no slot or page left beyond the
    heads, the session entries on disk, the journal holding exactly the
    answered ids. Launch counts are set to 0 after the build and read before
    the drain: every bf16 serving kernel launched, under the serve's launch
    rules, and no older body."""
    import shutil
    import tempfile

    import finchat_tpu_torch.engine.engine as engine_mod
    import finchat_tpu_torch.serve.app as app_mod
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.io.journal import AnsweredJournal
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from finchat_tpu_torch.utils.config import (AI_RESPONSE_TOPIC, USER_MESSAGE_TOPIC,
                                                KafkaConfig, load_config)
    from finchat_tpu_torch.utils.metrics import METRICS
    from finchat_tpu_torch.utils.tracing import TRACER

    t_phase = time.perf_counter()
    spec = PLANES["bf16"]
    gc.collect()  # the earlier phases' engines and trees are gone before this one
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="finchat-app-")
    port = _free_port()
    cfg = load_config(overrides={
        "model.preset": "llama3-8b", "engine.max_new_tokens": AGENT_NEW,
        "engine.temperature": 0.0, "kafka.commit_after_process": True,
        "engine.session_cache_disk_path": f"{tmp}/sessions", "journal.path": f"{tmp}/journal",
        "tracing.flight_dir": f"{tmp}/flight", "serve.host": "127.0.0.1", "serve.port": port})
    store = InMemoryStore()
    t_hist = int(time.time()) - 600
    for i in range(APP_CONVS):
        store.upsert_context(f"app-{i}", _app_context(i))
        store.add_user_message(f"app-{i}", MESSAGES[i], f"user-app-{i}", timestamp=t_hist)
    broker = InMemoryBroker()
    retriever = _TurnRetriever(structured=False)
    # the build's parts, timed where build_app calls them
    timed: dict = {}
    load, warmup = app_mod._load_model_artifacts, engine_mod.InferenceEngine.warmup

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        out = load(*a, **k)
        torch.cuda.synchronize()
        timed["weights_s"] = time.perf_counter() - t0
        timed["weights_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
        return out

    def timed_warmup(self):
        t0 = time.perf_counter()
        out = warmup(self)
        timed["warmup_s"] = time.perf_counter() - t0
        return out

    app_mod._load_model_artifacts = timed_load
    engine_mod.InferenceEngine.warmup = timed_warmup
    t0 = time.perf_counter()
    try:
        app = app_mod.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                                retriever=retriever, device=dev)
    finally:
        app_mod._load_model_artifacts = load
        engine_mod.InferenceEngine.warmup = warmup
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    sched = app.scheduler
    engine = sched.engine
    config = engine.config
    tok = app.agent.tool_generator.tokenizer
    head_pages = sum(len(e.pages) for e in sched._prefixes)
    log(f"  app build ({card}): build_app {build_s:.1f} s — weights {timed['weights_s']:.1f} s "
        f"({timed['weights_gb']:.2f} GB), warmup {timed['warmup_s']:.1f} s "
        f"({engine.compiled_variants} step variants); peak {build_peak:.2f} GB above the "
        f"{base / 1e9:.2f} GB held before; tokenizer {tok.vocab_size} ids wide; prompt heads "
        f"registered by the app: {len(app._registered_heads)} ({head_pages} pages)")
    if tok.vocab_size != config.vocab_size or len(app._registered_heads) != 2 or not head_pages:
        fail("app turns: build_app did not give a vocab-wide tokenizer and two registered heads")
    # the decision greedy under its grammar, as the earlier phases decode it
    app.agent.tool_sampling = SamplingParams(temperature=0.0, max_new_tokens=DECISION_NEW,
                                             grammar="tool_call")
    handles: list = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    counts = _Counts(engine)
    watcher = KafkaClient(KafkaConfig(), broker=broker)
    watcher.setup_consumer(topics=[AI_RESPONSE_TOPIC])  # latest: joins before any produce
    producer = KafkaClient(KafkaConfig(), broker=broker)
    outbound: list = []

    def drain_watcher() -> int:
        n = 0
        while (m := watcher.poll_message()) is not None:
            outbound.append(m.value())
            n += 1
        return n

    payloads: dict = {}
    produced_at: dict = {}

    def produce(conv: int, mid: str, text: str) -> None:
        payload = {"message": text, "conversation_id": f"app-{conv}",
                   "user_id": f"user-app-{conv}", "message_id": mid}
        payloads[mid] = payload
        produced_at[mid] = time.time()
        producer.produce_message(USER_MESSAGE_TOPIC, payload["conversation_id"], payload)

    def completes() -> int:
        drain_watcher()
        return sum(json.loads(v).get("type") == "complete" for v in outbound)

    m0 = METRICS.snapshot()
    reset_launches()
    TRACER.clear()
    wall_offset = time.time() - time.perf_counter()
    out: dict = {}
    try:
        await app.start(serve_http=True)
        # turn 1: four conversations at once
        t_turns = time.perf_counter()
        for i in range(APP_CONVS):
            produce(i, f"app-m{i}", MESSAGES[i])
        await _wait_for(lambda: completes() >= APP_CONVS,
                        "app turns: turn 1 did not complete", APP_WAIT_S)
        hits1 = _metric_delta(METRICS, m0, "finchat_prefix_hits_total")
        # turn 2 of two conversations: the history now holds turn 1's answer
        s0 = METRICS.snapshot()
        for i in range(APP_TURN2):
            store.add_user_message(f"app-{i}", MESSAGES[4 + i], f"user-app-{i}")
            produce(i, f"app-m{i}-t2", MESSAGES[4 + i])
        await _wait_for(lambda: completes() >= APP_CONVS + APP_TURN2,
                        "app turns: turn 2 did not complete", APP_WAIT_S)
        turns_s = time.perf_counter() - t_turns
        session_hits = _metric_delta(METRICS, s0, "finchat_session_cache_hits_total")
        await _wait_for(lambda: not app._inflight, "app turns: a message stayed in flight")
        # a redelivery of an answered message
        n_before = len(outbound)
        d0 = METRICS.get("finchat_kafka_dedupe_skips_total")
        producer.produce_message(USER_MESSAGE_TOPIC, "app-0", payloads["app-m0"])
        await _wait_for(lambda: METRICS.get("finchat_kafka_dedupe_skips_total") > d0,
                        "app turns: the redelivered message was not deduped")
        await _wait_for(lambda: not app._inflight, "app turns: the redelivery stayed in flight")
        drain_watcher()
        dedupe = dict(skips=METRICS.get("finchat_kafka_dedupe_skips_total") - d0,
                      new_records=len(outbound) - n_before)
        if dedupe != dict(skips=1, new_records=0):
            fail(f"app turns: the redelivery was answered again or not counted: {dedupe}")
        # HTTP, from a worker thread: the server shares this loop
        http_out: dict = {}
        http_out["health"] = await asyncio.to_thread(_http, port, "GET", "/health")
        store.add_user_message("app-3", MESSAGES[6], "user-app-3")
        status, ctype, text = await asyncio.to_thread(
            _http, port, "POST", "/chat/stream",
            {"conversation_id": "app-3", "message": MESSAGES[6], "user_id": "user-app-3"},
            {"x-trace-id": "app-http-1"})
        sse = [json.loads(line[6:]) for line in text.split("\n") if line.startswith("data: ")]
        http_out["stream"] = (status, ctype, len(sse))
        if (status, ctype) != (200, "text/event-stream"):
            fail(f"app turns: /chat/stream answered {status} {ctype}: {text[:500]}")
        retrieved_http, _count = check_turn_protocol("bf16", "app /chat/stream", sse)
        status, ctype, metrics_text = await asyncio.to_thread(_http, port, "GET", "/metrics")
        families = _prometheus_families(metrics_text)
        want_families = {"finchat_ttft_seconds", "finchat_kafka_produced_total",
                         "finchat_kafka_commits_total", "finchat_kafka_dedupe_skips_total",
                         "finchat_durability_journal_appends_total"}
        http_out["metrics"] = (status, ctype, len(families))
        if status != 200 or not want_families <= families:
            fail(f"app turns: /metrics {status} lacks {sorted(want_families - families)}")
        status, ctype, trace_text = await asyncio.to_thread(_http, port, "GET",
                                                            "/debug/trace/app-m0")
        names = [e["name"] for e in json.loads(trace_text)["traceEvents"]] if status == 200 else []
        http_out["trace"] = (status, len(names))
        if "ingress" not in names or "first_token" not in names:
            fail(f"app turns: /debug/trace/app-m0 ({status}) lacks ingress or first_token: "
                 f"{sorted(set(names))}")
        if http_out["health"] != (200, "application/json", '{"status": "healthy"}'):
            fail(f"app turns: /health answered {http_out['health']}")
        log(f"  app HTTP ({card}): /health ok; /chat/stream {len(sse)} events in the reference "
            f"order (retrieved {retrieved_http}); /metrics {len(families)} families, "
            f"Prometheus text; /debug/trace/app-m0 {len(names)} events with ingress and "
            "first_token")
        # the window's launches, read before the drain
        launches = dict(LAUNCHES)
        decode_steps = _metric_delta(METRICS, m0, "finchat_decode_dispatches_total")
        rounds = _metric_delta(METRICS, m0, "finchat_mixed_dispatches_total")
        missing = [k for k in spec["kernels"] if launches[k] == 0]
        if missing:
            fail(f"app turns: kernels not launched on the app's path: {missing}")
        check_window("bf16", "app turns", spec, config, launches, counts, decode_steps, rounds)
        out["launches"] = {k: v for k, v in launches.items() if v}
        # the drain
        sp0 = METRICS.get("finchat_durability_spills_total")
        drain_t0 = time.perf_counter()
        await app.drain_and_stop()
        drain_s = time.perf_counter() - drain_t0
        drain_watcher()
    finally:
        sched.submit = submit
        counts.close()
        watcher.close()
    entries = list(sched.session_cache._entries)
    on_disk = [k for k in entries if k in sched.session_cache.disk]
    leak = dict(used=sched.allocator.used_count, heads=head_pages,
                free_slots=len(sched.free_slots), max_seqs=cfg.engine.max_seqs,
                live=len(sched.decoding) + len(sched.prefilling) + len(sched.pending))
    log(f"  app drain ({card}): {drain_s:.2f} s; pages {leak['used']} (the heads' "
        f"{head_pages}), free slots {leak['free_slots']}/{leak['max_seqs']}, live "
        f"{leak['live']}; session entries {len(entries)} in RAM, {len(on_disk)} on disk, spills "
        f"+{METRICS.get('finchat_durability_spills_total') - sp0:.0f}")
    if leak["used"] != head_pages or leak["free_slots"] != leak["max_seqs"] or leak["live"]:
        fail(f"app turns: the drain left work, a slot or a page: {leak}")
    if not entries or len(on_disk) != len(entries):
        fail(f"app turns: session entries not all on disk after the drain: {entries} / {on_disk}")
    sched.retire_prefixes()
    if sched.allocator.used_count != 0:
        fail(f"app turns: {sched.allocator.used_count} pages after retire_prefixes")
    journal = AnsweredJournal(cfg.journal.path, num_partitions=broker.num_partitions)
    journaled = sorted(journal.replay(compact=False))
    journal.close()
    if journaled != sorted(payloads):
        fail(f"app turns: the journal holds {journaled}, the answered ids are {sorted(payloads)}")
    # the chunks, the store, the handles
    texts = _check_chunks("Kafka", outbound, payloads)
    ai_by_conv: dict = {}
    for m in store._messages:
        if m["sender"] == "AIMessage":
            ai_by_conv.setdefault(m["conversation_id"], []).append(m["message"])
    for i in range(APP_CONVS):
        # the Kafka turns persist their answers; the SSE path does not
        mids = [f"app-m{i}"] + ([f"app-m{i}-t2"] if i < APP_TURN2 else [])
        want = [texts[mid] for mid in mids]
        got = ai_by_conv.get(f"app-{i}", [])
        if got != want:
            fail(f"app turns: app-{i}'s stored answers {got} are not its chunks {want}")
    vocab = await app.agent.tool_generator._grammar_vocabs["tool_call"]
    if len(vocab.token_strs) != config.vocab_size:
        fail(f"app turns: the grammar is {len(vocab.token_strs)} ids wide")
    checks, rows = [], []
    params = engine.params
    for h in handles:
        if not (h.finished and h.generated > 0):
            continue
        decision = h.conversation_id.endswith("#tool")
        _stream_ended("bf16", "app turns", h, tok.eos_id)
        checks.append(teacher_forced_check(torch, params, config, h, "",
                                           vocab=vocab if decision else None))
    for mid in list(payloads) + ["app-http-1"]:
        mine = [h for h in handles if h.trace_id == mid]
        response = [h for h in mine if h.conversation_id.endswith("#resp")]
        marks = [ev for ev in TRACER.snapshot() if ev[1] == mid]
        ingress = next((ev[0] for ev in marks if ev[2] == "ingress"), None)
        start = next((ev[0] for ev in marks if ev[2] == "decide_start"), None)
        if ingress is None or start is None or not response or \
                response[-1].first_token_at is None:
            fail(f"app turns: {mid} has no ingress, decide_start or response first token")
        rows.append(dict(
            message_id=mid, ttft_s=response[-1].first_token_at - ingress,
            app_share_s=start - ingress,
            queue_s=None if mid not in produced_at else ingress + wall_offset - produced_at[mid],
            resumed=max(h.resumed_len for h in mine), shared=max(h.shared_len for h in mine),
            resumed_past_head=any(h.resumed_len > h.shared_len for h in mine),
            response_tokens=response[-1].generated, chunk_chars=len(texts.get(mid, "")),
            grafted=response[-1].grafted))
        log(f"  app turn {mid} ({card}): TTFT from ingress {rows[-1]['ttft_s']:.3f} s, of which "
            f"the app before the agent's turn {rows[-1]['app_share_s'] * 1e3:.2f} ms"
            + ("" if rows[-1]["queue_s"] is None else
               f"; produce -> ingress {rows[-1]['queue_s'] * 1e3:.1f} ms")
            + f"; {rows[-1]['shared']} shared, {rows[-1]['resumed']} resumed tokens; response "
            f"{rows[-1]['response_tokens']} tokens, {rows[-1]['chunk_chars']} text chars")
    kafka_rows = [r for r in rows if r["message_id"] != "app-http-1"]
    turn2 = [r for r in rows if r["message_id"].endswith("-t2")]
    if hits1 <= 0:
        fail("app turns: turn 1 did not hit the heads the app registered")
    if session_hits < APP_TURN2 or not all(r["resumed_past_head"] for r in turn2):
        fail(f"app turns: turn 2 did not resume through the session cache: hits "
             f"{session_hits}, rows {turn2}")
    ttft = sorted(r["ttft_s"] for r in kafka_rows)
    share = sorted(r["app_share_s"] for r in kafka_rows)
    http_row = rows[-1]
    out.update(
        build_s=build_s, weights_s=timed["weights_s"], warmup_s=timed["warmup_s"],
        weights_gb=timed["weights_gb"], build_peak_gb=build_peak,
        phase_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
        turns_s=turns_s, drain_s=drain_s, prefix_hits_turn1=hits1,
        session_hits_turn2=session_hits, dedupe=dedupe, http=http_out,
        ttft_p50_s=statistics.median(ttft), ttft_s=ttft,
        app_share_p50_s=statistics.median(share), http_ttft_s=http_row["ttft_s"],
        http_app_share_s=http_row["app_share_s"], turns=rows, teacher_forced=checks,
        journaled=journaled)
    del app, engine, sched, params, handles, recording_submit, submit
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  app turns ({card}): {len(kafka_rows)} Kafka turns in {turns_s:.2f} s; TTFT from "
        f"ingress p50 {out['ttft_p50_s']:.3f} s, the app's share p50 "
        f"{out['app_share_p50_s'] * 1e3:.2f} ms; /chat/stream TTFT {out['http_ttft_s']:.3f} s "
        f"(the app's share {out['http_app_share_s'] * 1e3:.2f} ms); prefix hits turn 1 "
        f"{hits1:.0f}, session hits turn 2 {session_hits:.0f}; {len(checks)} streams "
        f"teacher-forced; the phase took {out['phase_s']:.1f} s")
    return out


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


# the engine's ``named_scope`` ranges (utils/tracing.py): under a profiler
# each also spans its kernels on the card's timeline, so it is no kernel of
# its own and is left out of the device time by class
ENGINE_RANGES = frozenset({"kv_append", "kv_scatter", "paged_attention", "kv_scatter_ragged",
                           "ragged_paged_attention"})


def device_ms(torch, prof, classify, runs: int = 1, top: int = 4) -> tuple[dict, dict]:
    """Device milliseconds per run by kernel class from a profile, and the
    ``top`` largest kernels of the class "other"."""
    by_class: dict[str, float] = {}
    others: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key in ENGINE_RANGES:
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
    out["device_trace"] = check_device_trace(torch, engine, decode)
    engine.reset_slots(list(range(active)))
    return out


def check_device_trace(torch, engine, decode) -> dict:
    """``utils/tracing.device_trace`` over two decode steps: the profiler
    trace it writes must hold the engine's ``kv_append`` and
    ``paged_attention`` ranges, one a layer a step (host ranges; the card's
    copies of them counted beside)."""
    import shutil
    import tempfile

    from finchat_tpu_torch.utils.tracing import device_trace

    log_dir = tempfile.mkdtemp(prefix="finchat-profile-")
    try:
        with device_trace(log_dir):
            decode()
            decode()
        path = Path(log_dir) / "trace.json"
        trace = json.loads(path.read_text())
        size = path.stat().st_size
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    want = 2 * engine.config.n_layers
    ranges = {}
    for name in ("kv_append", "paged_attention"):
        evs = [e for e in trace["traceEvents"] if e.get("name") == name]
        ranges[name] = dict(host=sum(1 for e in evs if e.get("cat") == "user_annotation"),
                            device=sum(1 for e in evs if e.get("cat") == "gpu_user_annotation"))
    log(f"  device_trace over two decode steps: {size} bytes, ranges {ranges} (want {want} "
        "host ranges of each)")
    if any(r["host"] != want for r in ranges.values()):
        fail("device_trace: the profiler trace lacks the engine's ranges")
    return dict(bytes=size, ranges=ranges)


class _Dequantized:
    """A stacked quantized leaf read one layer at a time as its dequantized
    bf16 weight (``leaf[i]``, how the forward slices a layer), so the plain
    forward never holds the whole bf16 tree."""

    def __init__(self, leaf):
        self.leaf = leaf

    def __getitem__(self, i):
        from finchat_tpu_torch.models.quant import dequantize

        return dequantize(self.leaf[i])


def grammar_masks(vocab, served: list[int], budget: int):
    """The token sets ``TokenConstraint.pick`` chose each served token from:
    after the tokens before it (the grammar's state), with the budget left
    (the feasibility rule), EOS where the state accepts; only EOS where
    nothing is feasible. One [vocab] bool array a served token."""
    import numpy as np

    only_eos = np.zeros(len(vocab.token_strs), bool)
    only_eos[vocab.eos_id] = True
    state = vocab.dfa.start
    for i, token in enumerate(served):
        allowed, eos_ok, ends = vocab.mask(state)
        feasible = allowed & (vocab._distance_np[ends] <= budget - i - 2)
        if not (feasible.any() or eos_ok):
            yield only_eos
        else:
            allowed = feasible.copy()
            if eos_ok:
                allowed[vocab.eos_id] = True
            yield allowed if allowed.any() else only_eos
        if token != vocab.eos_id:
            state = vocab.advance(state, token)


def teacher_forced_check(torch, params, config, h, kv_quant: str, vocab=None) -> dict:
    """Re-run one served stream through the plain dense forward (no cache,
    plain attention, plain matmuls) and require the served greedy token
    wherever the plain forward's top-2 logit margin exceeds 0.25 — bf16
    activations through 32 layers move logits by a few hundredths, so a
    larger margin cannot flip. A quantized tree runs on its dequantized
    weights; an int8 KV cache is mirrored by quantizing and dequantizing
    every K/V row (``quantize_kv_rows``) before attention, so both sides see
    the same values. A stream that rode a shared head or resumed cached
    pages is checked over its whole history all the same: the served
    tokens must not depend on where their KV came from. With ``vocab`` (a
    grammar-constrained stream) the argmax and the margin are taken under
    the grammar mask each token was picked under (``grammar_masks``)."""
    from finchat_tpu_torch.engine.kv_cache import quantize_kv_rows
    from finchat_tpu_torch.models.llama import dense_causal_attention, forward, lm_head
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

    ids = h.history[:-1]
    n_prompt = len(h.prompt_ids)
    dev = params["embed"].device
    tokens = torch.tensor([ids], dtype=torch.int64, device=dev)
    positions = torch.arange(len(ids), device=dev)[None]
    attention = q8_attention if kv_quant else dense_causal_attention
    with torch.no_grad():
        hidden, _ = forward(plain, tokens, positions, config=config, attention=attention,
                            return_hidden=True)
        logits = lm_head(plain, hidden[0, n_prompt - 1:], config=config)
    if not bool(torch.isfinite(logits).all().item()):
        fail(f"teacher-forced check of {h.seq_id}: non-finite logits from the plain forward")
    served_ids = h.history[n_prompt:]
    if vocab is not None:
        import numpy as np

        masks = torch.from_numpy(np.stack(list(grammar_masks(
            vocab, served_ids, h.sampling.max_new_tokens)))).to(dev)
        logits = logits[: masks.shape[0]].float().masked_fill(~masks, float("-inf"))
    top2 = torch.topk(logits, 2, dim=-1)
    margin = (top2.values[:, 0] - top2.values[:, 1]).cpu()
    want = top2.indices[:, 0].cpu()
    served = torch.tensor(served_ids, dtype=torch.int64)
    n = min(len(served), len(want))
    decided = margin[:n] > 0.25  # inf where the mask leaves one token
    agree = (want[:n] == served[:n])
    bad = int((decided & ~agree).sum())
    what = "the plain forward's argmax" + (" under the grammar mask" if vocab is not None else "")
    log(f"  teacher-forced {h.seq_id} ({n_prompt} prompt tokens, {h.shared_len} shared, "
        f"{h.resumed_len} resumed): {int(agree.sum())}/{n} served tokens equal {what}; "
        f"{int(decided.sum())} have margin > 0.25, {bad} of those disagree")
    if bad:
        fail(f"teacher-forced check: {h.seq_id}'s served tokens disagree with the plain forward")
    del plain, logits, hidden
    return dict(seq_id=h.seq_id, tokens=n, agree=int(agree.sum()), decided=int(decided.sum()),
                masked=vocab is not None)


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
    for phase, plane, n_req, max_new, profile, drills, agent in (
            (3, "bf16", 8, 64, True, ("breaker", "preemption"),
             ("constrained", "partial", "turns", "overlap")),
            (4, "int8+kv8", 8, 64, True, ("breaker",), ("constrained", "turns")),
            (5, "int4g128+kv8", 2, 16, False, (), ())):
        log(f"phase {phase}: serve llama3-8b ({plane}, random weights) through LLMService")
        stats = asyncio.run(serve(torch, dev, plane, n_req, max_new, profile,
                                  later_turns=profile, drills=drills, agent=agent))
        log(f"  TTFT p50 {stats['ttft_p50_s']:.3f} s; decode "
            f"{stats['decode_tokens_per_s']:.1f} tokens/s aggregate, "
            f"{stats['decode_tokens_per_s_per_stream']:.1f} per stream; offloads "
            f"{stats['turn1']['offload']['total_s']:.3f} s ({card})")
        for turn in ("turn2", "turn3"):
            if turn in stats:
                t = stats[turn]
                log(f"  {turn}: TTFT p50 {t['ttft_p50_s']:.3f} s; restores "
                    f"{t['restore']['total_s']:.3f} s, offloads {t['offload']['total_s']:.3f} s "
                    f"({card})")
        tr = stats["tracing"]["host_us_per_dispatch"]
        log(f"  tracing on: {tr['8'][0]:.2f}-{tr['8'][1]:.2f} µs of host a decode dispatch at 8 "
            f"rows, {tr['64'][0]:.2f}-{tr['64'][1]:.2f} at 64 (the ring empty to 20,000 events; "
            f"{card})")
        if stats["agent"]:
            c = stats["agent"]["step_cost"]
            log(f"  constrained: decode step {c['decode_step_ms']:.3f} ms, with one constrained "
                f"row {c['decode_step_one_constrained_row_ms']:.3f} ms; fetch of one row "
                f"{c['fetch_one_row_ms']:.3f} ms; host pick {c['host_pick_ms']:.3f} ms ({card})")
            for i, row in enumerate(stats["agent"].get("partial", {}).get("holds", [])):
                log(f"  partial hold {i}: TTFT from the graft {row['ttft_from_graft_s']:.3f} s, a "
                    f"plain submit's {row['plain_ttft_s']:.3f} s ({card})")
            turns = stats["agent"]["turns"]
            for row in turns["engine_turns"]:
                lead = ("" if row["hold_lead_s"] is None else
                        f", the hold {row['hold_lead_s']:.3f} s before its end")
                log(f"  agent turn {row['conv']}: decision {row['decision_tokens']} tokens in "
                    f"{row['decision_s']:.3f} s{lead}; response TTFT from the turn's start "
                    f"{row['ttft_from_turn_start_s']:.3f} s ({card})")
            for name, run in turns.get("overlap", {}).get("runs", {}).items():
                log(f"  agent overlap {name}: response TTFT from the turn's start "
                    + ", ".join(f"{r['ttft_s']:.3f}" for r in run["turns"])
                    + f" s; finchat_tool_overlap_saved_seconds {run['overlap_saved']['total_s']:.3f}"
                    f" s over {run['overlap_saved']['n']} ({card})")
        log("serve: " + json.dumps(stats))
        serves[plane] = stats
        if plane == "bf16":
            log("phase 3, app_turns: llama3-8b (bf16, random weights) through the serving app: "
                "build_app, Kafka, HTTP, the journal")
            del stats
            app = asyncio.run(app_turns(torch, dev, card))
            log("app: " + json.dumps(app))

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
