"""Inference engine: prefill/decode step functions over the paged KV cache.

Shape discipline follows the JAX package, so the two compare like with
like:

- ``prefill_step``: ``N x prefill_chunk`` tokens — N sequences advance one
  chunk together (the scheduler pads N to a power of two); exhausted
  prompts ride with ``n_valid = 0`` and write the trash page.
- ``decode_step``: the full ``max_seqs`` slot batch every step; inactive
  slots write the trash page.
- ``decode_loop_step``: the same slot batch, ``decode_loop_depth`` fused
  decode iterations a dispatch (sampling and the per-slot EOS mask on the
  device); on the card one CUDA graph a depth, replayed a block
  (``DecodeLoopGraph``).
- ``verify_step``: spec decode's ``[last_token, drafts]`` forward a slot,
  the accepted prefix and one model token committed together.
- ``ragged_mixed_step``: ONE packed ragged dispatch advancing every
  prefilling sequence a chunk, every decoding slot a token, every spec
  slot a (1+Kd)-token verify row, and every loop slot a fused
  ``decode_loop_depth - 1``-token tail — rows of a packed token buffer
  (ops/ragged_paged_attention.py) padded to a pow-2 bucket, each row with
  its own length, page list and sampling params.
- ``ragged_multi_round``: the free-running loop, ``freerun_rounds``
  ragged rounds over staged descriptors (ops/freerun.py) in one dispatch.
- ``ring_prefill_step`` / ``ring_prefill_segment_step``: a long prompt (or
  one segment of it) prefilled with its sequence split over the mesh's
  ``seq`` ranks, by ring or Ulysses attention (``ops/ring_attention.py``,
  ``ops/ulysses.py``).

The KV cache is updated IN PLACE: a step plans its token rows once
(``plan_kv_rows``, ``plan_kv_rows_ragged``: ops/kv_append.py), and every
layer writes its K/V rows through ``kv_write`` — on the card one launch of
the KV-row writer for decode rows, prefill chunks and ragged rounds alike,
on the CPU the indexed chunk scatter. The JAX package donates its state to
every jitted step and aliases the append kernel's output to its input to
get the same effect; in PyTorch a step writes the tensors it was given. The
step functions mutate ``state`` and return it for symmetry with the
reference.

With ``EngineConfig.kv_quant = "int8"`` the pages are int8 with
per-token-per-head scale planes: every write quantizes its rows (the
writer's int8 entry, ``scatter_kv_chunk_q8`` on the CPU) and every
attention read dequantizes them. ``InferenceEngine(quant="int8" |
"int4")`` serves int8/int4 weights through the fused dequant-matmul
kernel.

Bounded KV (``kv_sink_pages`` / ``kv_window_pages``): the engine builds
and validates the sink + window policy (``bounded_kv``) and holds each
slot's eviction gap in ``state.kv_gaps``; the scheduler evicts. Every step
writes and masks at compacted positions, on the same kernels.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from finchat_tpu_torch.engine.kv_cache import (
    BoundedKVPolicy,
    PagedKVCache,
    gather_kv_any,
    gather_pages_host,
    scatter_pages_device,
)
from finchat_tpu_torch.engine.sampler import sample
from finchat_tpu_torch.models.llama import LlamaConfig, forward, lm_head
from finchat_tpu_torch.models.quant import (
    Q4Tensor,
    QTensor,
    quantize_llama_params,
    validate_quant_mode,
)
from finchat_tpu_torch.ops.dispatch import kv_write, paged_attention, ragged_paged_attention
from finchat_tpu_torch.ops.kv_append import plan_kv_rows, plan_kv_rows_ragged
from finchat_tpu_torch.ops.ragged_paged_attention import plan_ragged
from finchat_tpu_torch.utils.config import EngineConfig
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS
from finchat_tpu_torch.utils.tracing import named_scope

logger = get_logger(__name__)

# A fleet's engines share one card and one process: a replica's device-state
# rebuild runs in a worker thread (the breaker's and the supervisor's) while
# its siblings serve on the event loop's thread. A CUDA graph capture and an
# allocation of a whole pool on another thread are kept apart by this lock.
DEVICE_STATE_LOCK = threading.Lock()

I32 = torch.int32


def round_up_pow2(n: int) -> int:
    """The batch/shape padding policy shared by the scheduler's prefill
    rounds and the packed-token buckets."""
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class DecodeState:
    """Device-resident engine state.

    ``k_scales``/``v_scales`` are the int8 cache's scale planes, ``None``
    for a float cache (the JAX package keeps placeholders there only for
    its pytree's shape). ``kv_gaps`` is the bounded-KV compaction offset
    per slot (``kv_cache.BoundedKVPolicy``): the tokens evicted from the
    slot's page list, so every KV write and mask runs at ``context_lens -
    kv_gaps``; 0 for an unbounded engine, where each compacted expression
    is the absolute one. The scheduler's eviction wave writes it in place
    (``set_kv_gap_rows``). ``generator`` is the sampling noise source (the
    JAX package's ``rng`` key)."""

    k_pages: torch.Tensor  # [L, P, page_size, Hkv*hd] (model dtype, or int8)
    v_pages: torch.Tensor
    k_scales: torch.Tensor | None  # [L, P, scale_rows, page_size] fp32, int8 cache only
    v_scales: torch.Tensor | None
    page_table: torch.Tensor  # [max_seqs, max_pages_per_seq] int32 (0 = trash)
    context_lens: torch.Tensor  # [max_seqs] int32 — tokens seen (rotary)
    last_tokens: torch.Tensor  # [max_seqs] int32 — next decode input per slot
    kv_gaps: torch.Tensor  # [max_seqs] int32 — evicted tokens per slot (bounded KV)
    generator: torch.Generator


def create_state(config: LlamaConfig, engine_cfg: EngineConfig, max_pages_per_seq: int,
                 device: torch.device, kv_quant: str = "") -> DecodeState:
    cache = PagedKVCache.create(config, engine_cfg.num_pages, engine_cfg.page_size, device,
                                kv_quant=kv_quant)
    B = engine_cfg.max_seqs
    gen = torch.Generator(device=device)
    gen.manual_seed(B)
    return DecodeState(
        k_pages=cache.k_pages,
        v_pages=cache.v_pages,
        k_scales=cache.k_scales,
        v_scales=cache.v_scales,
        page_table=torch.zeros((B, max_pages_per_seq), dtype=I32, device=device),
        context_lens=torch.zeros((B,), dtype=I32, device=device),
        last_tokens=torch.zeros((B,), dtype=I32, device=device),
        kv_gaps=torch.zeros((B,), dtype=I32, device=device),
        generator=gen,
    )


def _cache(state: DecodeState) -> tuple:
    """The (k_pages, v_pages, k_scales, v_scales) tuple the model forward
    hands every attention callback (scales ``None`` for a float cache)."""
    return (state.k_pages, state.v_pages, state.k_scales, state.v_scales)


def _paged_attention_fn(page_table: torch.Tensor, start_pos: torch.Tensor,
                        n_valid: torch.Tensor, chunk: int, page_size: int, n_kv: int):
    """The model's attention callback for paged prefill/decode.

    ``page_table`` [B, max_pages], ``start_pos`` [B] (position of the first
    query token), ``n_valid`` [B] (real tokens in this chunk; 0 for inactive
    decode slots), ``chunk`` tokens a sequence (1 at decode). The step's
    KV rows are planned here once; each layer writes its chunk through
    ``kv_write`` (the KV-row writer on the card, quantizing for an int8
    cache), reading K and V where they lie. The write lands before the
    attention launch on the same stream, and ``kv_len`` counts the chunk's
    own tokens. Under a profiler the write is the ``kv_append`` range at
    decode and ``kv_scatter`` for a chunk, the attention ``paged_attention``
    (the JAX engine's scope names)."""
    kv_len = (start_pos + n_valid).to(I32)
    kv_rows = plan_kv_rows(page_table, start_pos, n_valid, chunk, page_size)
    write_scope = "kv_append" if chunk == 1 else "kv_scatter"

    def attention(q, k, v, cache, layer_idx: int):
        k_pages, v_pages, k_scales, v_scales = cache
        scales = dict(k_scales=k_scales, v_scales=v_scales)
        N = k.shape[0] * k.shape[1]
        with named_scope(write_scope):
            kv_write(kv_rows, k.reshape(N, -1), v.reshape(N, -1), k_pages, v_pages, layer_idx,
                     n_kv=n_kv, **scales)
        with named_scope("paged_attention"):
            out = paged_attention(q, k_pages, v_pages, page_table, start_pos, kv_len,
                                  layer_idx, page_size=page_size, n_kv=n_kv, **scales)
        return out, cache

    return attention


def prefill_step(
    params: dict[str, Any],
    state: DecodeState,
    tokens: torch.Tensor,  # [N, C] — one chunk of N sequences' prompts
    slots: torch.Tensor,  # [N] int32
    start_pos: torch.Tensor,  # [N] int32 — absolute position of tokens[i, 0]
    n_valid: torch.Tensor,  # [N] int32 — real tokens in this chunk per sequence
    *,
    config: LlamaConfig,
    page_size: int,
) -> tuple[DecodeState, torch.Tensor]:
    """Run one prefill chunk for N sequences; returns (state, last-valid-token
    logits [N, vocab] fp32). Only each sequence's last valid row is
    projected to the vocabulary."""
    N, C = tokens.shape
    dev = tokens.device
    slots_l = slots.long()
    positions = start_pos[:, None] + torch.arange(C, device=dev, dtype=I32)[None, :]
    page_rows = state.page_table[slots_l]
    # compacted positions; the clamp holds a padding row (n_valid 0, start 0)
    # on a slot that has evicted at 0, where a real row never goes below
    attention = _paged_attention_fn(
        page_rows, (start_pos - state.kv_gaps[slots_l]).clamp(min=0).to(I32), n_valid, C,
        page_size, config.local_kv_heads,
    )
    hidden, _ = forward(params, tokens, positions, config=config, attention=attention,
                        cache=_cache(state), return_hidden=True)
    last = (n_valid.long() - 1).clamp(min=0)
    last_hidden = hidden[torch.arange(N, device=dev), last]  # [N, D]
    last_logits = lm_head(params, last_hidden, config=config)
    state.context_lens.index_add_(0, slots_l, n_valid.to(I32))
    return state, last_logits


def commit_first_token(state: DecodeState, slot: int, logits: torch.Tensor,
                       temperature: float, top_p: float, top_k: int,
                       ) -> tuple[DecodeState, torch.Tensor]:
    """Sample the first generated token from prefill logits and arm the slot
    for decode; returns (state, token as a 0-d int32 device tensor)."""
    dev = logits.device
    token = sample(
        logits[None], state.generator,
        torch.tensor([temperature], dtype=torch.float32, device=dev),
        torch.tensor([top_p], dtype=torch.float32, device=dev),
        torch.tensor([top_k], dtype=I32, device=dev),
    )[0]
    state.last_tokens[slot] = token
    return state, token


def _decode_iteration(params: dict[str, Any], state: DecodeState, live: torch.Tensor,
                      temperature: torch.Tensor, top_p: torch.Tensor, top_k: torch.Tensor, *,
                      config: LlamaConfig, page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The body of one decode step for ALL slots, shared by ``decode_step``,
    ``decode_loop_step`` and the ragged round's fused tail: each ``live``
    slot's last token is appended at its context length (the others write
    the trash page), every slot samples, and ``context_lens`` and
    ``last_tokens`` are updated IN PLACE, so a captured CUDA graph reads and
    writes the same storage at every replay. Returns (next_tokens [B],
    step logits [B, vocab])."""
    tokens = state.last_tokens[:, None]
    positions = state.context_lens[:, None]
    n_valid = live.to(I32)
    attention = _paged_attention_fn(
        state.page_table, (state.context_lens - state.kv_gaps).to(I32), n_valid, 1,
        page_size, config.local_kv_heads,
    )
    logits, _ = forward(params, tokens, positions, config=config, attention=attention,
                        cache=_cache(state))
    step_logits = logits[:, 0, :]
    next_tokens = sample(step_logits, state.generator, temperature, top_p, top_k)
    state.context_lens.add_(n_valid)
    state.last_tokens.copy_(torch.where(live, next_tokens, state.last_tokens))
    return next_tokens, step_logits


def decode_step(
    params: dict[str, Any],
    state: DecodeState,
    active: torch.Tensor,  # [max_seqs] bool
    temperature: torch.Tensor,  # [max_seqs]
    top_p: torch.Tensor,  # [max_seqs]
    top_k: torch.Tensor,  # [max_seqs] int32
    *,
    config: LlamaConfig,
    page_size: int,
    return_logits: bool = False,
) -> tuple[DecodeState, torch.Tensor, torch.Tensor | None]:
    """One decode step for ALL slots; returns (state, next_tokens [max_seqs],
    step logits [max_seqs, vocab] or None). Each active slot's last token
    is appended at its context length; inactive slots write the trash page
    and their sampled tokens are ignored by the host."""
    next_tokens, step_logits = _decode_iteration(params, state, active, temperature, top_p,
                                                 top_k, config=config, page_size=page_size)
    return state, next_tokens, (step_logits if return_logits else None)


def decode_loop_step(
    params: dict[str, Any],
    state: DecodeState,
    active: torch.Tensor,  # [max_seqs] bool
    temperature: torch.Tensor,  # [max_seqs]
    top_p: torch.Tensor,  # [max_seqs]
    top_k: torch.Tensor,  # [max_seqs] int32
    eos_id: torch.Tensor,  # 0-d int32 (< 0 disables the stop mask)
    *,
    config: LlamaConfig,
    page_size: int,
    loop_depth: int = 4,
) -> tuple[DecodeState, torch.Tensor]:
    """``loop_depth`` fused decode iterations in ONE dispatch: the host pays
    one dispatch and one ``[K, max_seqs]`` token fetch a block instead of
    one a token. Each iteration is exactly the ``decode_step`` body (same
    forward, KV writes, sampling with one draw set of the state's generator
    an iteration), so a K-block greedy stream is token for token K single
    steps.

    The stop mask is on the device: a slot that samples ``eos_id`` has the
    EOS recorded, then rides the remaining iterations inactive (KV writes to
    the trash page, ``context_lens`` frozen, output -1). Slots inactive at
    entry stay -1 throughout. Returns ``(state, block [K, max_seqs])``.

    On the card ``InferenceEngine.decode_loop`` replays this function
    captured as one CUDA graph a depth; the eager function is the CPU path
    and the plain version the graph is held against. Slots that need host
    control a token (grammar picks, spec drafts, slots within K tokens of
    their budget) must not ride a block: the scheduler demotes them."""
    B = active.shape[0]
    live = active
    block = torch.full((loop_depth, B), -1, dtype=I32, device=active.device)
    for i in range(loop_depth):
        next_tokens, _ = _decode_iteration(params, state, live, temperature, top_p, top_k,
                                           config=config, page_size=page_size)
        block[i] = torch.where(live, next_tokens, -1)
        # EOS is recorded above, THEN the slot goes inactive
        live = live & (next_tokens != eos_id)
    return state, block


def verify_step(
    params: dict[str, Any],
    state: DecodeState,
    active: torch.Tensor,  # [max_seqs] bool
    drafts: torch.Tensor,  # [max_seqs, Kd] int32 — host-proposed draft tokens
    n_drafts: torch.Tensor,  # [max_seqs] int32 — live drafts a slot (0 = plain decode)
    temperature: torch.Tensor,  # [max_seqs]
    top_p: torch.Tensor,  # [max_seqs]
    top_k: torch.Tensor,  # [max_seqs] int32
    *,
    config: LlamaConfig,
    page_size: int,
    return_logits: bool = False,
) -> tuple[DecodeState, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The speculative verify step (prompt lookup): one forward over
    ``[last_token, draft_1..draft_Kd]`` a slot scores every draft in one
    weights-read; the accepted prefix plus one model token commit together.
    Returns ``(state, emitted [B, K], n_emitted [B], position-0 logits or
    None)`` with ``K = Kd + 1``; ``emitted[b, :n_emitted[b]]`` are the
    slot's tokens of this step (1..K).

    Greedy acceptance: draft i commits iff it equals THIS forward's argmax
    at its position, and position i attends only to positions <= i, so
    acceptance never changes a token, only how many commit a step.
    Draft-free slots (non-greedy, grammar-constrained) sample position 0
    with the full sampler, as ``decode_step`` does; ``return_logits`` hands
    the position-0 logits to the host for a constrained pick. Rejected
    drafts' KV lands beyond the new ``context_lens``: masked by every later
    step and overwritten when those positions are reached."""
    B, Kd = drafts.shape
    K = Kd + 1
    dev = drafts.device
    tokens = torch.cat([state.last_tokens[:, None], drafts.to(I32)], dim=1)  # [B, K]
    positions = state.context_lens[:, None] + torch.arange(K, device=dev, dtype=I32)[None, :]
    n_valid = torch.where(active, 1 + n_drafts.to(I32), torch.zeros_like(n_drafts)).to(I32)
    attention = _paged_attention_fn(
        state.page_table, (state.context_lens - state.kv_gaps).to(I32), n_valid, K,
        page_size, config.local_kv_heads,
    )
    logits, _ = forward(params, tokens, positions, config=config, attention=attention,
                        cache=_cache(state))  # [B, K, vocab]
    preds = torch.argmax(logits, dim=-1).to(I32)
    col = torch.arange(1, K, device=dev)[None, :]
    match = (col <= n_drafts[:, None]) & (tokens[:, 1:] == preds[:, :-1])
    accepted = torch.cumprod(match.to(I32), dim=1).sum(dim=1).to(I32)
    n_emitted = torch.where(active, accepted + 1, torch.zeros_like(accepted)).to(I32)
    step_logits = logits[:, 0, :]
    sampled0 = sample(step_logits, state.generator, temperature, top_p, top_k)
    emitted = torch.cat([sampled0[:, None], preds[:, 1:]], dim=1)
    last = torch.gather(emitted, 1, accepted.long()[:, None])[:, 0]
    state.context_lens.add_(n_emitted)
    state.last_tokens.copy_(torch.where(active, last, state.last_tokens))
    return state, emitted, n_emitted, (step_logits if return_logits else None)


def _ragged_attention_fn(
    page_rows: torch.Tensor,  # [R, max_pages] per-ROW page lists
    tok_row: torch.Tensor,  # [T] int32 — owning row per packed token (R = padding)
    tok_pos: torch.Tensor,  # [T] int32 — absolute position per packed token
    row_kv_len: torch.Tensor,  # [R] int32 — valid KV per row incl. this dispatch
    page_size: int,
    n_kv: int,
    group: int,  # query heads per KV head
    row_gap: torch.Tensor,  # [R] int32 — bounded-KV eviction gap of the row's slot
    tok_valid: torch.Tensor | None = None,  # [T] bool — a real token of a live row
):
    """Attention callback for the packed ragged step: every valid packed
    token's K/V row lands at its own compacted position through its row's
    page list; padding tokens and the tokens of a dead free-run row
    (``tok_valid`` False; None = every row live) write the trash page,
    while ``tok_row`` keeps its ascending order with the padding as
    suffix, as the tiles need. Then the
    ragged attention reads each row's pages in place. The round's
    descriptors (compacted positions and lengths, tiles, rows) and its KV
    rows are built here once and shared by every layer's call, over either
    cache. Under a profiler they are the ``kv_scatter_ragged`` and
    ``ragged_paged_attention`` ranges."""
    plan = plan_ragged(tok_row, tok_pos, row_kv_len, group=group, kv_gap=row_gap)
    kv_rows = plan_kv_rows_ragged(page_rows, tok_row, plan.tok_pos, page_size,
                                  tok_valid=tok_valid)

    def attention(q, k, v, cache, layer_idx: int):
        k_pages, v_pages, k_scales, v_scales = cache
        T = k.shape[1]
        with named_scope("kv_scatter_ragged"):
            kv_write(kv_rows, k.reshape(T, -1), v.reshape(T, -1), k_pages, v_pages, layer_idx,
                     n_kv=n_kv, k_scales=k_scales, v_scales=v_scales)
        with named_scope("ragged_paged_attention"):
            out = ragged_paged_attention(q[0], k_pages, v_pages, page_rows, tok_row, tok_pos,
                                         row_kv_len, layer_idx, page_size=page_size, n_kv=n_kv,
                                         kv_gap=row_gap, k_scales=k_scales, v_scales=v_scales,
                                         plan=plan)
        return out[None], cache

    return attention


def _ragged_round_math(
    params: dict[str, Any],
    state: DecodeState,
    tokens: torch.Tensor,  # [T] int32 PACKED token buffer (0 at device-read positions)
    tok_row: torch.Tensor,  # [T] int32 — owning row, ascending contiguous (R = padding)
    row_slot: torch.Tensor,  # [R] int32 — engine slot per row
    row_start: torch.Tensor,  # [R] int32 — abs pos of the row's first token (prefill)
    row_len: torch.Tensor,  # [R] int32 — tokens in the row (0 = padding row)
    row_from_device: torch.Tensor,  # [R] bool — token 0 reads last_tokens[slot] and the
    #   row starts at context_lens[slot] (decode rows, spec verify rows)
    row_arm: torch.Tensor,  # [R] bool — commit this row's sampled token to last_tokens
    row_n_drafts: torch.Tensor,  # [R] int32 — spec rows: row_len == 1 + n_drafts
    temperature: torch.Tensor,  # [R] — PER-ROW sampling params
    top_p: torch.Tensor,  # [R]
    top_k: torch.Tensor,  # [R] int32
    loop_active: torch.Tensor,  # [max_seqs] bool — slots riding the fused tail
    loop_temperature: torch.Tensor,  # [max_seqs] — per-SLOT params for the tail
    loop_top_p: torch.Tensor,  # [max_seqs]
    loop_top_k: torch.Tensor,  # [max_seqs] int32
    eos_id: torch.Tensor,  # 0-d int32 (< 0 disables the tail's stop mask)
    row_live: torch.Tensor | None,  # [R] bool — the free-run stop mask (None = all live)
    *,
    config: LlamaConfig,
    page_size: int,
    spec_width: int = 0,
    loop_depth: int = 1,
) -> tuple[DecodeState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The packed ragged round body, shared by ``ragged_mixed_step`` and the
    free-run capture ``ragged_multi_round``, so a captured round is the same
    math as a host-stepped one.

    ``row_live`` is the decode loop's per-slot stop mask over the ragged
    rows: a dead row rides the round inert — its KV writes go to the trash
    page, nothing arms, its slot's ``context_lens`` and ``last_tokens``
    stay as they were, and it emits 0. The single round passes None
    (every row live), which leaves every gate below out. (See
    ``ragged_mixed_step`` for the row contract.)"""
    T = tokens.shape[0]
    R = row_slot.shape[0]
    B = state.context_lens.shape[0]
    W = spec_width + 1
    dev = tokens.device
    slot_l = row_slot.long()
    tok_row = tok_row.to(I32)
    safe_row = tok_row.long().clamp(max=R - 1)
    tok_valid = tok_row < R
    dead_rows = row_live is not None
    if dead_rows:
        # a dead row's tokens write the trash page and arm nothing; tok_row
        # itself keeps the rows' ascending order
        tok_valid = tok_valid & row_live[safe_row]
        row_arm = row_arm & row_live
    q_start = torch.cumsum(row_len, 0, dtype=I32) - row_len  # [R] exclusive
    tok_off = torch.arange(T, device=dev, dtype=I32) - q_start[safe_row]
    eff_start = torch.where(row_from_device, state.context_lens[slot_l], row_start)
    tok_pos = torch.where(tok_valid, eff_start[safe_row] + tok_off,
                          torch.zeros_like(tok_off)).to(I32)
    row_last = state.last_tokens[slot_l]
    tok_in = torch.where(tok_valid & row_from_device[safe_row] & (tok_off == 0),
                         row_last[safe_row], tokens)
    page_rows = state.page_table[slot_l]
    row_kv_len = torch.where(row_len > 0, eff_start + row_len,
                             torch.zeros_like(row_len)).to(I32)
    row_gap = state.kv_gaps[slot_l]

    attention = _ragged_attention_fn(page_rows, tok_row, tok_pos, row_kv_len, page_size,
                                     config.local_kv_heads, config.n_heads // config.n_kv_heads,
                                     row_gap, **({"tok_valid": tok_valid} if dead_rows else {}))
    hidden, _ = forward(params, tok_in[None], tok_pos[None], config=config,
                        attention=attention, cache=_cache(state), return_hidden=True)
    h = hidden[0]  # [T, D]
    # sampling positions: a spec row needs logits at every row position (for
    # the drafts' acceptance); every other row only at its last valid token,
    # where all W columns point, so column 0 is always the sampling position
    last_off = (row_len - 1).clamp(min=0)
    if W == 1:
        sel_idx = (q_start + last_off).clamp(0, T - 1).long()
        logits = lm_head(params, h[sel_idx], config=config)[:, None]  # [R, 1, vocab] fp32
    else:
        col = torch.arange(W, device=dev, dtype=I32)[None, :]
        sel_off = torch.where((row_n_drafts > 0)[:, None], torch.minimum(col, last_off[:, None]),
                              last_off[:, None])
        sel_idx = (q_start[:, None] + sel_off).clamp(0, T - 1).long()  # [R, W]
        logits = lm_head(params, h[sel_idx.reshape(-1)], config=config).reshape(R, W, -1)
    preds = torch.argmax(logits, dim=-1).to(I32)  # [R, W]
    if W > 1:
        # verify_step's acceptance over the packed drafts: draft column i
        # (1..W-1) commits while every earlier draft matched and it equals
        # the model's prediction for its position
        cols_d = torch.arange(1, W, device=dev, dtype=I32)[None, :]
        draft_tok = tok_in[(q_start[:, None] + cols_d).clamp(0, T - 1).long()]
        match = (cols_d <= row_n_drafts[:, None]) & (draft_tok == preds[:, :-1])
        accepted = torch.cumprod(match.to(I32), dim=1).sum(dim=1).to(I32)
    else:
        accepted = torch.zeros((R,), dtype=I32, device=dev)
    row_logits = logits[:, 0, :]  # [R, vocab] — each row's sampling position
    sampled0 = sample(row_logits, state.generator, temperature, top_p, top_k)
    emitted = torch.cat([sampled0[:, None], preds[:, 1:]], dim=1)  # [R, W]
    spec = row_n_drafts > 0
    zeros = torch.zeros_like(accepted)
    n_emitted = torch.where(row_arm, torch.where(spec, accepted + 1, zeros + 1), zeros).to(I32)
    last_tok = torch.gather(emitted, 1, accepted.long()[:, None])[:, 0]
    # context advance: a spec row moves by what it emitted (rejected drafts'
    # KV stays beyond the new length), every other row by its packed length
    # (a chunk, 1 for decode, 0 for padding), a dead row not at all
    advance = torch.where(spec, n_emitted, row_len.to(I32))
    if dead_rows:
        advance = torch.where(row_live, advance, zeros)
    # last_tokens commits as a DELTA add, so duplicate-slot padding rows
    # (delta 0) cannot race the real row's write
    delta = torch.where(row_arm, last_tok - row_last, zeros)
    state.context_lens.index_add_(0, slot_l, advance.to(I32))
    state.last_tokens.index_add_(0, slot_l, delta.to(I32))

    # the fused tail: loop slots run loop_depth - 1 further iterations in
    # the same dispatch, the decode_loop_step body (same forward, writes,
    # sampling, stop mask), reading the tokens committed above
    block = torch.full((max(loop_depth - 1, 0), B), -1, dtype=I32, device=dev)
    if loop_depth > 1:
        live = loop_active & (state.last_tokens != eos_id)
        for i in range(loop_depth - 1):
            next_tokens, _ = _decode_iteration(params, state, live, loop_temperature,
                                               loop_top_p, loop_top_k, config=config,
                                               page_size=page_size)
            block[i] = torch.where(live, next_tokens, -1)
            live = live & (next_tokens != eos_id)
    return state, emitted, n_emitted, row_logits, block


def ragged_mixed_step(
    params: dict[str, Any],
    state: DecodeState,
    tokens: torch.Tensor,
    tok_row: torch.Tensor,
    row_slot: torch.Tensor,
    row_start: torch.Tensor,
    row_len: torch.Tensor,
    row_from_device: torch.Tensor,
    row_arm: torch.Tensor,
    row_n_drafts: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    loop_active: torch.Tensor,
    loop_temperature: torch.Tensor,
    loop_top_p: torch.Tensor,
    loop_top_k: torch.Tensor,
    eos_id: torch.Tensor,
    *,
    config: LlamaConfig,
    page_size: int,
    spec_width: int = 0,
    loop_depth: int = 1,
) -> tuple[DecodeState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """ONE packed ragged dispatch advancing every serving population at
    once: prefill chunks of any length, 1-token decode rows,
    grammar-constrained rows (host picks from the returned logits) and
    (1+Kd)-token spec verify rows are rows of one packed buffer;
    loop-eligible decode slots then run ``loop_depth - 1`` further fused
    iterations in the same dispatch. Returns ``(state, emitted [R, W],
    n_emitted [R], row_logits [R, vocab], loop_block [loop_depth-1,
    max_seqs])`` with ``W = spec_width + 1``.

    - Device-read rows (``row_from_device``) take their first token from
      ``state.last_tokens[slot]`` and start at ``context_lens[slot]`` on the
      device; spec rows' drafts ride the packed buffer at offsets 1..Kd.
    - Spec acceptance is ``verify_step``'s; ``emitted[r, :n_emitted[r]]``
      are the row's tokens (1..Kd+1 for spec rows, 1 for armed plain rows,
      0 for mid-prompt prefill rows).
    - ``row_logits`` is each row's sampling-position logits (position 0 of
      a device row, the last valid chunk token of a prefill row).
    - One draw set of the state's generator for the round plus one a tail
      iteration, as ``decode_step`` / ``decode_loop_step`` draw.
    """
    return _ragged_round_math(
        params, state, tokens, tok_row, row_slot, row_start, row_len,
        row_from_device, row_arm, row_n_drafts, temperature, top_p, top_k,
        loop_active, loop_temperature, loop_top_p, loop_top_k, eos_id,
        None,  # every row live: the host stepped this round
        config=config, page_size=page_size, spec_width=spec_width, loop_depth=loop_depth,
    )


def ragged_multi_round(
    params: dict[str, Any],
    state: DecodeState,
    tokens: torch.Tensor,  # [F, T] int32 — staged packed token buffer a round
    tok_row: torch.Tensor,  # [F, T] int32
    row_slot: torch.Tensor,  # [R] int32 — the row/slot binding is fixed across the run
    row_start: torch.Tensor,  # [F, R] int32
    row_len: torch.Tensor,  # [F, R] int32
    row_from_device: torch.Tensor,  # [F, R] bool
    row_arm: torch.Tensor,  # [F, R] bool
    temperature: torch.Tensor,  # [R] — per-row sampling params (fixed across rounds)
    top_p: torch.Tensor,  # [R]
    top_k: torch.Tensor,  # [R] int32
    loop_active: torch.Tensor,  # [F, max_seqs] bool — staged fused-tail schedule
    loop_temperature: torch.Tensor,  # [max_seqs]
    loop_top_p: torch.Tensor,  # [max_seqs]
    loop_top_k: torch.Tensor,  # [max_seqs] int32
    eos_id: torch.Tensor,  # 0-d int32
    *,
    config: LlamaConfig,
    page_size: int,
    loop_depth: int = 1,
) -> tuple[DecodeState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The free-running serving loop: ``F = freerun_rounds`` consecutive
    ragged rounds of the ``_ragged_round_math`` body over staged
    descriptors (``ops/freerun.stage_freerun``), enqueued back to back with
    no host read between them.

    - The leading ``[F, ...]`` axis is a queue the rounds drain in order;
      a prompt that completes in round r is staged as a device-read decode
      row from round r + 1 (its first token commits to ``last_tokens`` on
      the device).
    - Budget stops are staged away by the host; EOS is the device's: each
      round recomputes ``row_live`` from ``last_tokens[row_slot] ==
      eos_id`` for device-read rows, so a row that committed EOS (in its
      round or its tail) rides every later round inert, emitting 0.
    - Output ring: ``ring_tokens [F, R]`` (each armed row's token),
      ``ring_n [F, R]`` (0 = mid-prompt chunk or dead row),
      ``ring_blocks [F, loop_depth-1, max_seqs]`` (the fused tails).

    No spec rows ride a capture (drafts are proposed from delivered
    tokens), so ``spec_width`` is 0. Returns ``(state, ring_tokens,
    ring_n, ring_blocks)``. Round r is the same math as the r-th
    host-stepped ``ragged_mixed_step`` over the same descriptors."""
    F = tokens.shape[0]
    R = row_slot.shape[0]
    slot_l = row_slot.long()
    no_drafts = torch.zeros((R,), dtype=I32, device=tokens.device)
    ring_tokens, ring_n, ring_blocks = [], [], []
    for r in range(F):
        row_live = ~(row_from_device[r] & (state.last_tokens[slot_l] == eos_id))
        state, emitted, n_emitted, _row_logits, blk = _ragged_round_math(
            params, state, tokens[r], tok_row[r], row_slot, row_start[r], row_len[r],
            row_from_device[r], row_arm[r], no_drafts, temperature, top_p, top_k,
            loop_active[r], loop_temperature, loop_top_p, loop_top_k, eos_id, row_live,
            config=config, page_size=page_size, spec_width=0, loop_depth=loop_depth,
        )
        ring_tokens.append(emitted[:, 0])
        ring_n.append(n_emitted)
        ring_blocks.append(blk)
    return state, torch.stack(ring_tokens), torch.stack(ring_n), torch.stack(ring_blocks)


def _sp_attention_fn(mesh: Any, page_row: torch.Tensor, start_pos: int, n_valid: int, S: int,
                     page_size: int, n_kv: int, sp_mode: str, prefix_pages: int):
    """The attention callback of a seq-sharded prefill of ``S`` tokens (a
    whole prompt, or one segment at ``start_pos``) into ``page_row`` [1,
    max_pages]: SP attention over the ``seq`` axis for the compute (ring or
    Ulysses by ``sp_mode``), and the cache write through ``kv_write``.

    The pages are replicated over ``seq``, so every seq rank writes every
    token's row: each layer gathers the K/V blocks over ``seq``
    (``parallel/collectives.gather_seq``) and writes the whole segment with
    one plan (``plan_kv_rows``; the KV-row writer on the card, quantizing for
    an int8 pool). Padding tokens (past ``n_valid``) write the trash page.

    With ``prefix_pages`` > 0 the cached earlier tokens (positions before
    ``start_pos``, the first ``prefix_pages`` pages of the row) are gathered
    (``gather_kv_any``: an int8 pool dequantized) and folded into the
    attention first; the gather comes before the segment's own write, so the
    fold sees only positions ``< start_pos``."""
    from finchat_tpu_torch.parallel.collectives import gather_seq

    if sp_mode == "ulysses":
        from finchat_tpu_torch.ops.ulysses import (
            ulysses_attention as attend,
            ulysses_attention_with_prefix as attend_with_prefix,
        )
    else:
        from finchat_tpu_torch.ops.ring_attention import (
            ring_attention as attend,
            ring_attention_with_prefix as attend_with_prefix,
        )
    dev = page_row.device
    plan = plan_kv_rows(page_row, torch.tensor([start_pos], dtype=I32, device=dev),
                        torch.tensor([n_valid], dtype=I32, device=dev), S, page_size)
    sp = dict(mesh=mesh, axis="seq", head_axis="model", causal=True)

    def attention(q, k, v, cache, layer_idx: int):
        k_pages, v_pages, k_scales, v_scales = cache
        with named_scope("ring_attention"):
            if prefix_pages:
                kp, vp = gather_kv_any(k_pages, v_pages, k_scales, v_scales,
                                       page_row[:, :prefix_pages], page_size, layer_idx, n_kv,
                                       dtype=q.dtype)
                out = attend_with_prefix(q, k, v, kp, vp, start_pos, **sp)
            else:
                out = attend(q, k, v, **sp)
        with named_scope("kv_scatter"):
            rows = k.shape[0] * k.shape[1]
            kw = gather_seq(k.reshape(rows, -1), mesh)
            vw = gather_seq(v.reshape(rows, -1), mesh)
            kv_write(plan, kw, vw, k_pages, v_pages, layer_idx, n_kv=n_kv, k_scales=k_scales,
                     v_scales=v_scales)
        return out, cache

    return attention


def _sp_prefill(params: dict[str, Any], state: DecodeState, tokens: torch.Tensor, slot: int,
                start_pos: int, n_valid: int, *, config: LlamaConfig, page_size: int, mesh: Any,
                sp_mode: str, prefix_pages: int) -> tuple[DecodeState, torch.Tensor]:
    """The body of both seq-sharded prefill steps on this rank: its block of
    ``tokens`` [1, S] (``S / n`` tokens at their absolute positions, so
    RoPE sees the whole prompt's) through the layers, tensor parallelism
    over ``model`` inside each seq coordinate as in every step. The last
    valid token sits on seq rank ``(n_valid - 1) // (S / n)``; its hidden
    row is broadcast over ``seq`` and every rank runs the head (gathered
    over ``model``), so every rank holds the same logits and launches the
    same head work."""
    from finchat_tpu_torch.parallel.collectives import broadcast_seq

    n, idx = mesh.shape["seq"], mesh.coords["seq"]
    S = tokens.shape[1]
    Sq = S // n
    dev = tokens.device
    positions = (start_pos + idx * Sq + torch.arange(Sq, device=dev, dtype=I32))[None, :]
    page_row = state.page_table[slot:slot + 1]
    attention = _sp_attention_fn(mesh, page_row, start_pos, n_valid, S, page_size,
                                 config.local_kv_heads, sp_mode, prefix_pages)
    hidden, _ = forward(params, tokens[:, idx * Sq:(idx + 1) * Sq], positions, config=config,
                        attention=attention, cache=_cache(state), return_hidden=True)
    last = max(n_valid - 1, 0)
    owner = last // Sq
    row = hidden[:, last - owner * Sq] if idx == owner else hidden.new_empty((1, hidden.shape[-1]))
    row = broadcast_seq(row, mesh, owner)
    last_logits = lm_head(params, row, config=config)[0]
    state.context_lens[slot:slot + 1].add_(n_valid)
    return state, last_logits


def ring_prefill_step(params: dict[str, Any], state: DecodeState, tokens: torch.Tensor,
                      slot: int, n_valid: int, *, config: LlamaConfig, page_size: int,
                      mesh: Any, sp_mode: str = "ring") -> tuple[DecodeState, torch.Tensor]:
    """Seq-sharded one-shot prefill of a long prompt (``tokens`` [1, S], the
    whole prompt padded to a seq multiple; ``n_valid`` real tokens): a
    rank's activations and attention state are O(S / seq), the exchange by
    ``sp_mode`` (ring hops, or Ulysses' head scatter). Returns (state, the
    last valid token's logits [vocab] fp32)."""
    return _sp_prefill(params, state, tokens, slot, 0, n_valid, config=config,
                       page_size=page_size, mesh=mesh, sp_mode=sp_mode, prefix_pages=0)


def ring_prefill_segment_step(params: dict[str, Any], state: DecodeState, tokens: torch.Tensor,
                              slot: int, start_pos: int, n_valid: int, *, config: LlamaConfig,
                              page_size: int, mesh: Any, prefix_pages: int,
                              sp_mode: str = "ring") -> tuple[DecodeState, torch.Tensor]:
    """One segment of a segmented seq-sharded prefill (``tokens`` [1, S] at
    absolute ``start_pos``): it attends to the cached earlier segments
    through the prefix fold and to itself through the ring (or Ulysses), so
    the scheduler can interleave decode steps between segments. Returns
    (state, the last valid token's logits [vocab]; the final segment's are
    the prompt's). ``prefix_pages`` (the caller's power-of-two bucket)
    bounds the gather and fold to the pages that can hold the prefix."""
    return _sp_prefill(params, state, tokens, slot, start_pos, n_valid, config=config,
                       page_size=page_size, mesh=mesh, sp_mode=sp_mode,
                       prefix_pages=prefix_pages)


def check_tp_servable(config: LlamaConfig, shape: dict[str, int]) -> None:
    """Refuse by name a mesh (its axis sizes) or a model the mesh engine does
    not serve: a ``data``, ``pipe`` or ``expert`` axis above 1, an MoE
    model, and a ``model`` axis that does not divide the heads or the KV
    heads. ``seq`` is served (the long-prompt prefill splits its sequence
    over it; every other step replicates over it). ``build_app`` asks before
    it starts any rank; the engine asks again."""
    others = {a: n for a, n in shape.items() if a not in ("model", "seq") and n > 1}
    if others:
        raise NotImplementedError(
            f"mesh: {others}: the pipeline, data and expert axes are not served yet; a "
            "serving mesh shards over seq and model only")
    if config.n_experts:
        raise NotImplementedError("mesh: an MoE model is not served on a mesh yet (expert and "
                                  "tensor parallelism for MoE are not ported)")
    from finchat_tpu_torch.parallel.sharding import check_kv_heads

    tp_size = shape["model"]
    if config.n_heads % tp_size:
        raise NotImplementedError(
            f"mesh: model={tp_size} does not divide n_heads={config.n_heads}; a rank must hold "
            "whole heads")
    check_kv_heads(config.n_kv_heads, tp_size)


def _place_tp(config: LlamaConfig, params: dict[str, Any], engine_cfg: EngineConfig, mesh: Any,
              quant: str, quant_group: int) -> tuple[LlamaConfig, dict[str, Any]]:
    """A tensor-parallel rank's config (``config.tp`` set) and weight shard
    (cut over ``model`` only: the same on every seq coordinate); refuses
    the planes this engine does not serve on a mesh, by name."""
    from finchat_tpu_torch.ops.tp_overlap import TPShard, chunk_row_parallel
    from finchat_tpu_torch.parallel.sharding import llama_param_shardings, shard_params

    check_tp_servable(config, mesh.shape)
    tp_size = mesh.shape["model"]
    if mesh.device.type == "cuda" and mesh.backend == "gloo" and engine_cfg.decode_loop_depth > 1:
        raise NotImplementedError(
            f"mesh: decode_loop_depth={engine_cfg.decode_loop_depth} over a gloo group on the "
            "card: a gloo collective cannot be captured in the decode loop's CUDA graph (use "
            "nccl, or decode_loop_depth=1)")
    if mesh.group("model") is None:
        raise ValueError("a TP engine needs a distributed mesh (parallel/mesh.build_mesh), not "
                         "a shape-only one")
    tp = TPShard(group=mesh.group("model"), size=tp_size, rank=mesh.coords["model"],
                 overlap=engine_cfg.tp_overlap, n_chunks=engine_cfg.tp_overlap_chunks)
    local = dataclasses.replace(config, tp=tp)
    full_q = config.n_heads * config.head_dim
    n_q = params["layers"]["attn_q"].shape[-1]
    if n_q == full_q:
        if quant:
            params = quantize_llama_params(params, mode=quant, group_size=quant_group)
        params = shard_params(params, llama_param_shardings(mesh), mesh)
    elif n_q * tp_size == full_q:
        if quant and not isinstance(params["layers"]["attn_q"], (QTensor, Q4Tensor)):
            raise ValueError("a float weight shard cannot be quantized on its rank (a "
                             "row-parallel scale spans every rank's rows): quantize the whole "
                             "tree, then shard it")
    else:
        raise ValueError(f"attn_q has {n_q} columns: neither the whole model's {full_q} nor a "
                         f"rank's {full_q // tp_size}")
    if tp.overlap:
        layers = dict(params["layers"])
        for name in ("attn_o", "mlp_down"):
            layers[name] = chunk_row_parallel(layers[name], tp.n_chunks)
        params = {**params, "layers": layers}
    return local, params


def _tp_broadcast_parts(local: torch.Tensor, tp: Any) -> list[torch.Tensor]:
    """Every rank's ``local`` tensor, in rank order, on every rank (one
    broadcast a rank: gloo takes broadcasts of CUDA tensors)."""
    import torch.distributed as dist

    parts = [local if r == tp.rank else torch.empty_like(local) for r in range(tp.size)]
    for r, part in enumerate(parts):
        dist.broadcast(part, src=dist.get_global_rank(tp.group, r), group=tp.group)
    return parts


def _gather_tp_record(state: DecodeState, page_ids: list[int], config: LlamaConfig) -> tuple:
    """``gather_pages_host``'s record of a tensor-parallel pool: every rank's
    KV of these pages (over its ``model`` group) made into one record of the
    one-device layout (``parallel/sharding.kv_full``)."""
    from finchat_tpu_torch.parallel.sharding import kv_full

    tp = config.tp
    ids = torch.as_tensor(page_ids, dtype=torch.long).to(state.k_pages.device)
    mine = [None if t is None else t.index_select(1, ids)
            for t in (state.k_pages, state.v_pages, state.k_scales, state.v_scales)]
    by_field = [None if t is None else _tp_broadcast_parts(t, tp) for t in mine]
    parts = [tuple(None if f is None else f[r].cpu() for f in by_field) for r in range(tp.size)]
    return kv_full(parts, config.n_kv_heads)


def _local_tp_record(host: tuple, config: LlamaConfig) -> tuple:
    """This rank's KV of a one-device record (``_gather_tp_record``'s
    inverse; ``parallel/sharding.kv_local``)."""
    from finchat_tpu_torch.parallel.sharding import kv_local

    return kv_local(*host, config.n_kv_heads, config.tp.size, config.tp.rank)


class InferenceEngine:
    """Host-side wrapper owning the device state and the step functions.

    Runs on ``device`` — ``"cuda"`` unless the caller asks for ``"cpu"``.
    It never falls back to the CPU: on a machine without a GPU, a CUDA
    engine raises at construction. ``params`` must already live on the
    device (the engine does not copy them: the 8B tree is 16 GB).

    ``quant`` ("int8" | "int4", ``quant_group`` rows of K per int4 scale, 0
    = per column) serves quantized weights: a float tree is quantized here,
    a tree that is already quantized (``models/quant.init_quantized_params``)
    is kept as it is. ``engine_cfg.kv_quant = "int8"`` makes the page pool
    int8 with scale planes.

    ``mesh`` (``parallel/mesh.build_mesh``) makes the engine one rank of a
    tensor-parallel group over the ``model`` axis, on the mesh's device
    (the JAX package's ``InferenceEngine(mesh=...)``, SPMD):

    - ``params`` is the whole tree (quantized first, then cut to this
      rank's Megatron shard by ``parallel/sharding.shard_params``) or the
      rank's shard already;
    - the pool is the rank's own ``[L, P, page_size, (Hkv / tp) * hd]``
      with the scale planes of its heads, and every step runs over the
      rank's heads with the layers' collectives on the axis's group
      (``models/llama._layer``, ``lm_head``); every rank samples the same
      token from the same full logits row and generator state;
    - ``engine.tp_overlap`` / ``tp_overlap_chunks`` chunk the row-parallel
      outputs (``ops/tp_overlap``), cut once here;
    - ``offload_pages`` gathers every rank's heads into one record of the
      one-device layout and ``restore_pages`` takes this rank's heads out
      of one, so a session record moves between a TP engine and a
      one-device engine either way.

    A ``seq`` axis above 1 adds sequence parallelism (the JAX package's
    ``mesh.seq``): the weights and the page pool are replicated over
    ``seq`` (sharded over ``model`` as above), every step runs alike on
    every seq coordinate, and a prompt of at least
    ``ring_prefill_min_tokens`` tokens prefills with its sequence split over
    the seq ranks (``prefill_ring``, or ``prefill_ring_segment`` a segment
    of ``ring_segment_tokens()`` at a time), by ring or Ulysses attention
    (``sp_mode``; Ulysses falls back to ring when the seq axis does not
    divide a shard's heads). A session record is read from seq coordinate
    0's ``model`` group (the pages are the same on every coordinate).

    Every rank must make the same calls in the same order
    (``parallel/ranks``). Refused by name: a ``data``, ``pipe`` or
    ``expert`` axis above 1, an MoE model, a ``model`` axis that does not
    divide ``n_heads`` or ``n_kv_heads``, and a decode loop deeper than 1
    over a gloo group on the card (a gloo collective cannot be captured in
    a CUDA graph)."""

    def __init__(self, config: LlamaConfig, params: dict[str, Any], engine_cfg: EngineConfig,
                 device: str | torch.device = "cuda", quant: str = "", quant_group: int = 0,
                 mesh: Any = None):
        validate_quant_mode(quant)
        device = torch.device(mesh.device if mesh is not None else device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("InferenceEngine on cuda: no CUDA device is available "
                                   "(pass device='cpu' to run the plain CPU path)")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        if params["embed"].device != device:
            raise ValueError(f"params live on {params['embed'].device}, engine on {device}")
        if params["embed"].dtype != config.dtype:
            raise ValueError(f"params are {params['embed'].dtype}, config is {config.dtype}")
        if mesh is not None:
            config, params = _place_tp(config, params, engine_cfg, mesh, quant, quant_group)
        elif quant:
            params = quantize_llama_params(params, mode=quant, group_size=quant_group)
        self.config = config
        self.params = params
        self.mesh = mesh
        self.quant = quant
        self.kv_quant = engine_cfg.kv_quant
        self.engine_cfg = engine_cfg
        self.device = device
        self.page_size = engine_cfg.page_size
        self.max_pages_per_seq = min(
            engine_cfg.num_pages - 1,
            -(-engine_cfg.max_seq_len // engine_cfg.page_size),
        )
        self.state = create_state(config, engine_cfg, self.max_pages_per_seq, device,
                                  kv_quant=self.kv_quant)
        # fused multi-step decode (decode_loop_step): tokens a dispatch;
        # 1 = decode_step only
        self.decode_loop_depth = max(1, engine_cfg.decode_loop_depth)
        # bounded KV serving: the sink + window eviction policy (host math;
        # the device side is state.kv_gaps and the compacted write and mask
        # positions of every step). None = unbounded
        policy = BoundedKVPolicy(max(0, engine_cfg.kv_sink_pages),
                                 max(0, engine_cfg.kv_window_pages), engine_cfg.page_size)
        if policy.enabled:
            policy.validate(prefill_chunk=engine_cfg.prefill_chunk,
                            max_pages_per_seq=self.max_pages_per_seq,
                            decode_loop_depth=self.decode_loop_depth,
                            spec_tokens=engine_cfg.spec_tokens)
        self.bounded_kv = policy if policy.enabled else None
        # the free-running loop (ragged_multi_round): ragged rounds a
        # dispatch; 1 = host-stepped rounds only
        self.freerun_rounds = max(1, engine_cfg.freerun_rounds)
        # on the card: decode_loop_step captured as a CUDA graph, one a depth
        # (dropped with the state it was captured over)
        self._loop_graphs: dict[int, DecodeLoopGraph] = {}
        # step variants the last warmup() ran (0 = not warmed); the
        # scheduler sets the finchat_warmup_compiled_variants gauge from it
        self.compiled_variants = 0
        # quantized expert leaves on the card: the expert products run on
        # inline-dequantized weights (models/llama.moe_mlp), not on a kernel.
        # Booked on finchat_quantmatmul_fallbacks_total, three (gate, up,
        # down) once per step kind, the first time the engine dispatches the
        # kind (warmup runs the steps directly and books none); the JAX
        # package counts them once per trace of a compiled step
        self._expert_fallback = (device.type == "cuda" and config.n_experts > 0 and isinstance(
            params["layers"]["moe_gate"], (QTensor, Q4Tensor)))
        self._fallback_kinds: set[str] = set()
        # the SP mode a seq-sharded prefill runs ("ring" | "ulysses")
        self.sp_mode = self._resolve_sp_mode(engine_cfg.sp_mode)

    def _resolve_sp_mode(self, sp_mode: str) -> str:
        """The configured SP mode checked against this model and mesh: an
        unknown mode raises; Ulysses needs a shard's heads divisible by the
        seq axis (``ops/ulysses.ulysses_supported``) and falls back to ring
        (always valid) otherwise, with a warning."""
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_mode {sp_mode!r} (supported: 'ring', 'ulysses')")
        if sp_mode == "ulysses" and self.mesh is not None:
            from finchat_tpu_torch.ops.ulysses import ulysses_supported

            c = self.config
            if not ulysses_supported(c.n_heads, c.n_kv_heads, self.mesh, axis="seq",
                                     head_axis="model"):
                logger.warning(
                    "sp_mode=ulysses needs per-shard heads divisible by the seq axis (H=%d, "
                    "Hkv=%d, mesh=%s); falling back to ring", c.n_heads, c.n_kv_heads,
                    self.mesh.shape)
                return "ring"
        return sp_mode

    def _count_fallback(self, kind: str) -> None:
        """Book the expert products of step kind ``kind`` on
        ``finchat_quantmatmul_fallbacks_total`` the first time it runs."""
        if self._expert_fallback and kind not in self._fallback_kinds:
            self._fallback_kinds.add(kind)
            METRICS.inc("finchat_quantmatmul_fallbacks_total", 3.0)

    @property
    def quant_label(self) -> str:
        """The serving quant mode as one label: "bf16", "int8" or "int4",
        with "+kv8" when the page pool is int8."""
        return (self.quant or "bf16") + ("+kv8" if self.kv_quant else "")

    # --- host <-> device -------------------------------------------------
    def to_device(self, array: Any, dtype: torch.dtype | None = None) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy goes
        through pinned memory without blocking the host, so enqueuing the
        next step does not wait for the one in flight."""
        t = torch.as_tensor(np.asarray(array))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @staticmethod
    def to_host(t: torch.Tensor) -> np.ndarray:
        """Fetch a device tensor (blocks until the producing step is done)."""
        return t.detach().cpu().numpy()

    # --- low-level ops used by the scheduler ----------------------------
    def set_page_table_row(self, slot: int, pages: list[int]) -> None:
        self.set_page_table_rows({slot: pages})

    def set_page_table_rows(self, rows: dict[int, list[int]]) -> None:
        """Assign several slots' page lists in ONE device update."""
        mat = np.zeros((len(rows), self.max_pages_per_seq), np.int32)
        for i, pages in enumerate(rows.values()):
            mat[i, : len(pages)] = pages
        idx = self.to_device(np.asarray(list(rows), np.int64))
        self.state.page_table[idx] = self.to_device(mat)

    def set_context_lens_rows(self, rows: dict[int, int]) -> None:
        idx = self.to_device(np.asarray(list(rows), np.int64))
        self.state.context_lens[idx] = self.to_device(np.asarray(list(rows.values()), np.int32))

    def set_kv_gap_rows(self, rows: dict[int, int]) -> None:
        """Set several slots' bounded-KV gaps in ONE device update (an
        eviction wave, a gapped resume). Writes ``state.kv_gaps`` in place,
        as ``set_page_table_rows`` writes the table: a captured decode-loop
        graph reads the state's own storage at every replay, so a rebound
        tensor would leave it reading a stale gap. The write is ordered
        after the steps already enqueued and before the next one."""
        idx = self.to_device(np.asarray(list(rows), np.int64))
        self.state.kv_gaps[idx] = self.to_device(np.asarray(list(rows.values()), np.int32))

    def set_last_token(self, slot: int, token: int) -> None:
        """Override a slot's next decode input (the host pick of a
        constrained slot). Writes ``state.last_tokens`` in place (every
        step updates that same tensor): the write is ordered after the
        steps already enqueued and before the next one, which reads it."""
        self.state.last_tokens[slot] = int(token)

    def select_rows(self, t: torch.Tensor, rows: list[int]) -> torch.Tensor:
        """Rows ``rows`` of a device tensor, selected on the device, so a
        fetch moves only those (a constrained slot's logits row, not the
        batch's)."""
        return t.index_select(0, self.to_device(np.asarray(rows, np.int64)))

    def reset_slot(self, slot: int) -> None:
        self.reset_slots([slot])

    def reset_slots(self, slots: list[int]) -> None:
        """Clear several slots in one device update."""
        idx = self.to_device(np.asarray(slots, np.int64))
        s = self.state
        s.page_table[idx] = 0
        s.context_lens[idx] = 0
        s.last_tokens[idx] = 0
        s.kv_gaps[idx] = 0

    def offload_pages(self, page_ids: list[int]) -> tuple:
        """Snapshot physical pages to the host (all layers, K, V and the
        int8 scale planes) for the session KV cache. Returns once the copy
        has landed: the caller is about to free these pages
        (kv_cache.gather_pages_host). Under tensor parallelism every rank
        calls it, and each rank of seq coordinate 0 gets the whole record:
        every rank's heads in head order, in the one-device layout (the
        pages are replicated over ``seq``; the other coordinates get
        None)."""
        s = self.state
        if self.config.tp is not None:
            if self.mesh.coords["seq"]:
                return None  # seq coordinate 0's ranks read it; a follower discards it
            return _gather_tp_record(s, page_ids, self.config)
        return gather_pages_host(s.k_pages, s.v_pages, s.k_scales, s.v_scales, page_ids)

    def restore_pages(self, page_ids: list[int], host: tuple) -> None:
        """Write a host snapshot back into freshly allocated pages (a session
        resume), in place on the current stream. Under tensor parallelism
        ``host`` is a whole record of the one-device layout and this rank
        writes its own heads."""
        s = self.state
        if self.config.tp is not None:
            host = _local_tp_record(host, self.config)
        scatter_pages_device(s.k_pages, s.v_pages, s.k_scales, s.v_scales, page_ids, host)

    def rebuild_device_state(self) -> None:
        """Replace the whole device state (the KV pool and its scale planes,
        page table, context lengths, last tokens, ``kv_gaps``, generator)
        with a fresh one, the weights kept: the scheduler's circuit breaker
        recovers a wedged or poisoned state this way, its sequences having
        been preempted to the host. The old state is dropped before the new
        one is allocated, so the peak stays at one pool; the allocation is
        ordered after every step already enqueued on the stream, which is
        what the freed blocks' last users were. Runs in a worker thread, so
        the engine's device is made current there first, and returns once
        the new pool is zeroed on the card: a device error surfaces here,
        inside the breaker's rebuild, and not at the first replayed step."""
        self.state = None  # drop the old pool before allocating the new one
        # the graphs read and write the old state's storage: recaptured over
        # the new one at their next use
        self._loop_graphs.clear()
        if self.device.type == "cuda":
            # never while a sibling engine captures a graph (DEVICE_STATE_LOCK)
            with DEVICE_STATE_LOCK, torch.cuda.device(self.device):
                self.state = create_state(self.config, self.engine_cfg, self.max_pages_per_seq,
                                          self.device, kv_quant=self.kv_quant)
                torch.cuda.synchronize(self.device)
        else:
            self.state = create_state(self.config, self.engine_cfg, self.max_pages_per_seq,
                                      self.device, kv_quant=self.kv_quant)

    def warmup(self) -> float:
        """Run every step variant the scheduler dispatches once, with
        state-neutral inputs, before the first request: the kernels'
        libraries load, cuBLAS initialises, and the caching allocator holds
        the largest step's blocks. The variants are the JAX engine's, and
        ``compiled_variants`` counts them the same way:

        - ``prefill_step`` at every power of two up to the scheduler's
          largest round (``round_up_pow2(max_seqs)``), ``n_valid = 0``:
          writes land on the trash page, context lengths gain zero;
        - ``ragged_mixed_step`` at every packed-token bucket (with
          ``mixed_step``) at the engine's spec width and loop depth, every
          row padding and no loop slot; with ``freerun_rounds`` > 1 also
          ``ragged_multi_round`` at every bucket, every round padding;
        - ``decode_step`` with ``return_logits`` False and True, every slot
          inactive; with ``decode_loop_depth`` > 1 ``decode_loop_step``
          (on the card then captured as its CUDA graph); with
          ``spec_tokens`` > 0 ``verify_step`` with ``return_logits`` False
          and True;
        - ``commit_first_token`` on slot 0 (its last token becomes 0; a
          slot's first prefill completion overwrites it);
        - on a ``seq > 1`` mesh, the seq-sharded prefill's buckets
          (``_warm_ring``).

        The decode steps sample at temperature 1.0, so warmup advances
        ``state.generator``; greedy streams do not see that. Returns the
        wall seconds."""
        t0 = time.perf_counter()
        cfg = self.engine_cfg
        B = cfg.max_seqs
        n_variants = 0
        prefill_batch_sizes = [1]
        while prefill_batch_sizes[-1] < round_up_pow2(B):
            prefill_batch_sizes.append(prefill_batch_sizes[-1] * 2)
        C = cfg.prefill_chunk
        # the step functions themselves, as the JAX engine's warmup calls
        # them: the engine's methods would count dispatches in the metrics
        dev = self.device
        step = dict(config=self.config, page_size=self.page_size)

        def zeros(*shape, dtype=I32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=dev)

        no_eos = torch.tensor(-1, dtype=I32, device=dev)
        loop = dict(loop_depth=self.decode_loop_depth)
        for n in prefill_batch_sizes:
            self.state, _ = prefill_step(self.params, self.state, zeros(n, C), zeros(n),
                                         zeros(n), zeros(n), **step)
            n_variants += 1
        if cfg.mixed_step:
            R = B
            flags, tail = zeros(R, dtype=torch.bool), (zeros(B, dtype=torch.bool), ones(B),
                                                       ones(B), zeros(B))
            for t in self.ragged_token_buckets():
                self.state, *_ = ragged_mixed_step(
                    self.params, self.state, zeros(t), torch.full((t,), R, dtype=I32, device=dev),
                    zeros(R), zeros(R), zeros(R), flags, flags, zeros(R),
                    zeros(R, dtype=torch.float32), ones(R), zeros(R), *tail, no_eos,
                    spec_width=cfg.spec_tokens, **loop, **step)
                n_variants += 1
            if self.freerun_rounds > 1:
                F = self.freerun_rounds
                for t in self.ragged_token_buckets():
                    self.state, *_ = ragged_multi_round(
                        self.params, self.state, zeros(F, t),
                        torch.full((F, t), R, dtype=I32, device=dev), zeros(R), zeros(F, R),
                        zeros(F, R), zeros(F, R, dtype=torch.bool),
                        zeros(F, R, dtype=torch.bool), zeros(R, dtype=torch.float32), ones(R),
                        zeros(R), zeros(F, B, dtype=torch.bool), ones(B), ones(B), zeros(B),
                        no_eos, **loop, **step)
                    n_variants += 1
        inactive = zeros(B, dtype=torch.bool)
        for return_logits in (False, True):
            self.state, _, _ = decode_step(self.params, self.state, inactive, ones(B), ones(B),
                                           zeros(B), return_logits=return_logits, **step)
            n_variants += 1
        if self.decode_loop_depth > 1:
            self.state, _ = decode_loop_step(self.params, self.state, inactive, ones(B), ones(B),
                                             zeros(B), no_eos, **loop, **step)
            n_variants += 1
            if dev.type == "cuda":
                self._loop_graph(self.decode_loop_depth)
        if cfg.spec_tokens > 0:
            for return_logits in (False, True):
                self.state, *_ = verify_step(self.params, self.state, inactive,
                                             zeros(B, cfg.spec_tokens), zeros(B), ones(B),
                                             ones(B), zeros(B), return_logits=return_logits,
                                             **step)
                n_variants += 1
        self.state, _ = commit_first_token(self.state, 0, zeros(self.config.vocab_size,
                                                                dtype=torch.float32),
                                           0.0, 1.0, 0)
        n_variants += 1
        if self.mesh is not None and self.mesh.shape.get("seq", 1) > 1:
            n_variants += self._warm_ring(step)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.compiled_variants = n_variants
        logger.info("engine warmup [%s]: prefill batches %s + %d step variants in %.1fs",
                    self.quant_label, prefill_batch_sizes, n_variants, elapsed)
        return elapsed

    def _warm_ring(self, step: dict) -> int:
        """The seq-sharded prefill's variants the JAX engine's warmup
        compiles, each run once with ``n_valid = 0`` (the writes go to the
        trash page): ``ring_prefill_step`` at every bucket the router can
        produce (segmented: ``bucket(min(ring_min, rc))`` to
        ``bucket(rc)``; monolithic: ``bucket(ring_min)`` up to the one
        covering ``max_seq_len``), and with segments the segment step at
        every prefix-page bucket a start can map to. Returns their count."""
        cfg = self.engine_cfg
        sp = dict(mesh=self.mesh, sp_mode=self.sp_mode, **step)
        rc = self.ring_segment_tokens()
        ring_min = cfg.ring_prefill_min_tokens
        if rc > 0:
            S, top = self._ring_bucket(min(ring_min, rc)), self._ring_bucket(rc)
        else:
            S, top = self._ring_bucket(ring_min), self._ring_bucket(cfg.max_seq_len)
        n = 0
        while True:
            self.state, _ = ring_prefill_step(self.params, self.state, self._token_row([], S), 0,
                                              0, **sp)
            n += 1
            if S >= top:
                break
            S = self._ring_bucket(S + 1)
        if rc > 0:
            pb = self._prefix_page_bucket(rc)
            top_pb = self._prefix_page_bucket(cfg.max_seq_len)
            while True:
                self.state, _ = ring_prefill_segment_step(
                    self.params, self.state, self._token_row([], rc), 0, rc, 0,
                    prefix_pages=pb, **sp)
                n += 1
                if pb >= top_pb:
                    break
                pb = min(pb * 2, top_pb)
        return n

    # --- steps -----------------------------------------------------------
    def prefill_chunk(self, tokens, slots, start_pos, n_valid) -> torch.Tensor:
        """One batched prefill chunk from host arrays; returns the
        last-valid-token logits [N, vocab] (device)."""
        self._count_fallback("prefill")
        d = self.to_device
        self.state, logits = prefill_step(
            self.params, self.state, d(tokens, I32), d(slots, I32), d(start_pos, I32),
            d(n_valid, I32),
            config=self.config, page_size=self.page_size,
        )
        return logits

    def prefill_batch(self, items: list[tuple[int, list[int]]]) -> list[torch.Tensor]:
        """Chunked prefill of N whole prompts together; returns each
        sequence's final-chunk last-token logits ([vocab] each, in order).
        Exhausted prompts ride the remaining rounds with ``n_valid = 0``.
        Prompts of at least ``ring_prefill_min_tokens`` on a ``seq > 1``
        mesh take the seq-sharded path instead (``prefill_ring``, one
        shot)."""
        assert items, "empty prefill batch"
        ring = [(i, slot, ids) for i, (slot, ids) in enumerate(items)
                if self._use_ring_prefill(len(ids))]
        if ring:
            results: list[torch.Tensor | None] = [None] * len(items)
            for i, slot, ids in ring:
                results[i] = self.prefill_ring(slot, ids)
            rest = [(i, it) for i, it in enumerate(items) if results[i] is None]
            if rest:
                for (i, _), lg in zip(rest, self.prefill_batch([it for _, it in rest])):
                    results[i] = lg
            return results  # type: ignore[return-value]
        C = self.engine_cfg.prefill_chunk
        N = len(items)
        slots = [slot for slot, _ in items]
        prompts = [ids for _, ids in items]
        assert all(prompts), "empty prompt in prefill batch"
        rounds = max(-(-len(p) // C) for p in prompts)
        last_logits: list[torch.Tensor | None] = [None] * N
        for r in range(rounds):
            chunk_tokens, n_valid, start = [], [], []
            for p in prompts:
                chunk = p[r * C:(r + 1) * C]
                n_valid.append(len(chunk))
                start.append(min(r * C, len(p)))
                chunk_tokens.append(chunk + [0] * (C - len(chunk)))
            logits = self.prefill_chunk(chunk_tokens, slots, start, n_valid)
            for i, p in enumerate(prompts):
                if n_valid[i] and r * C + n_valid[i] == len(p):
                    last_logits[i] = logits[i]
        assert all(lg is not None for lg in last_logits)
        return last_logits  # type: ignore[return-value]

    def prefill(self, slot: int, prompt_ids: list[int]) -> torch.Tensor:
        """Chunked prefill of a whole prompt into a slot; returns the final
        chunk's last-token logits and commits no token (a shared prefix's
        registration fills exactly its pages with it)."""
        return self.prefill_batch([(slot, prompt_ids)])[0]

    # --- the seq-sharded long-prompt prefill -----------------------------
    def _use_ring_prefill(self, prompt_len: int) -> bool:
        """Does a prompt of ``prompt_len`` tokens take the seq-sharded
        prefill? (A pure function of the length: every rank routes alike.)"""
        return (self.mesh is not None and self.mesh.shape.get("seq", 1) > 1
                and prompt_len >= self.engine_cfg.ring_prefill_min_tokens)

    def _ring_bucket(self, n: int) -> int:
        """A ring prefill's length padded to a power of two, rounded up to a
        seq multiple (the JAX engine's compiled shapes; the warmup runs
        each)."""
        n_seq = self.mesh.shape["seq"]
        return -(-round_up_pow2(n) // n_seq) * n_seq

    def _token_row(self, tokens: list[int], S: int) -> torch.Tensor:
        """``tokens`` padded with zeros to [1, S] on the device."""
        return self.to_device(np.asarray([tokens + [0] * (S - len(tokens))], np.int32))

    def prefill_ring(self, slot: int, prompt_ids: list[int]) -> torch.Tensor:
        """Seq-sharded one-shot prefill of a long prompt
        (``ring_prefill_step`` at ``_ring_bucket``); returns the last
        token's logits."""
        assert self.mesh is not None and self.mesh.shape.get("seq", 1) > 1
        n = len(prompt_ids)
        self.state, last_logits = ring_prefill_step(
            self.params, self.state, self._token_row(prompt_ids, self._ring_bucket(n)), slot, n,
            config=self.config, page_size=self.page_size, mesh=self.mesh, sp_mode=self.sp_mode)
        return last_logits

    def ring_segment_tokens(self) -> int:
        """The segment of the segmented SP prefill (0 = monolithic): the
        configured ``ring_prefill_chunk`` rounded up to a seq multiple; both
        SP modes have a segment variant."""
        rc = self.engine_cfg.ring_prefill_chunk
        if rc <= 0 or self.mesh is None:
            return 0
        n_seq = self.mesh.shape.get("seq", 1)
        return -(-rc // n_seq) * n_seq

    def _prefix_page_bucket(self, start_pos: int) -> int:
        """The page count of a segment's prefix gather: a power-of-two bucket
        of the pages holding positions [0, start_pos), capped at the row's
        width, and floored at the pages one segment spans (a prefix shorter
        than a segment, a shared head's hit on the first segment, takes the
        smallest bucket; the extra pages are masked, their cost at most one
        segment's)."""
        floor = -(-self.ring_segment_tokens() // self.page_size)
        need = max(-(-start_pos // self.page_size), 1)
        return min(max(round_up_pow2(need), round_up_pow2(floor)), self.max_pages_per_seq)

    def prefill_ring_segment(self, slot: int, seg_ids: list[int], start_pos: int
                             ) -> torch.Tensor:
        """One segment of a segmented seq-sharded prefill. A segment with no
        cached prefix (``start_pos == 0``) runs the plain ring step (the
        monolithic path's bucket); one with a prefix (a later segment, or a
        first one past a shared head) runs the prefix-fold step at the
        segment's shape. Returns the last valid token's logits (the final
        segment's are the prompt's)."""
        rc = self.ring_segment_tokens()
        assert rc > 0, "a segmented ring prefill needs ring_prefill_chunk > 0"
        n = len(seg_ids)
        assert 0 < n <= rc
        if start_pos == 0:
            return self.prefill_ring(slot, seg_ids)
        self.state, last_logits = ring_prefill_segment_step(
            self.params, self.state, self._token_row(seg_ids, rc), slot, start_pos, n,
            config=self.config, page_size=self.page_size, mesh=self.mesh,
            prefix_pages=self._prefix_page_bucket(start_pos), sp_mode=self.sp_mode)
        return last_logits

    def commit_first_token(self, slot: int, logits: torch.Tensor, temperature: float,
                           top_p: float, top_k: int) -> torch.Tensor:
        self.state, token = commit_first_token(self.state, slot, logits, temperature,
                                               top_p, top_k)
        return token

    def decode(self, active, temperature, top_p, top_k, return_logits: bool = False):
        """One decode step from host arrays; returns next tokens (device),
        with the step logits too when ``return_logits``."""
        METRICS.inc("finchat_decode_dispatches_total")
        self._count_fallback("decode")
        self.state, next_tokens, logits = decode_step(
            self.params, self.state, self.to_device(active, torch.bool),
            self.to_device(temperature, torch.float32), self.to_device(top_p, torch.float32),
            self.to_device(top_k, I32),
            config=self.config, page_size=self.page_size, return_logits=return_logits,
        )
        return (next_tokens, logits) if return_logits else next_tokens

    def ragged_token_buckets(self) -> list[int]:
        """Packed-token buckets for the ragged mixed step (ascending pow-2,
        floored at 64 tokens): the dispatch shape varies only in the packed
        buffer length (descriptors are fixed at ``[max_seqs]``)."""
        cfg = self.engine_cfg
        top = round_up_pow2(cfg.max_seqs * max(cfg.prefill_chunk, cfg.spec_tokens + 1))
        buckets = [min(64, top)]
        while buckets[-1] < top:
            buckets.append(buckets[-1] * 2)
        return buckets

    def ragged_bucket(self, n_tokens: int) -> int:
        """Smallest packed-token bucket holding ``n_tokens``."""
        return next(b for b in self.ragged_token_buckets() if b >= n_tokens)

    def ragged_mixed(self, tokens, tok_row, row_slot, row_start, row_len,
                     row_from_device, row_arm, temperature, top_p, top_k,
                     row_n_drafts=None, loop_active=None, loop_temperature=None,
                     loop_top_p=None, loop_top_k=None, eos_id: int = -1):
        """One packed ragged dispatch (see ragged_mixed_step) from host
        arrays; returns ``(emitted [R, W], n_emitted, row_logits,
        loop_block)`` device tensors. The spec and fused-tail arguments
        default to none: no drafts, no loop slot."""
        METRICS.inc("finchat_mixed_dispatches_total")
        self._count_fallback("ragged")
        d = self.to_device
        R = len(row_slot)
        B = self.engine_cfg.max_seqs
        if row_n_drafts is None:
            row_n_drafts = np.zeros((R,), np.int32)
        if loop_active is None:
            loop_active = np.zeros((B,), bool)
        tail = [np.zeros((B,), np.float32) if loop_temperature is None else loop_temperature,
                np.ones((B,), np.float32) if loop_top_p is None else loop_top_p,
                np.zeros((B,), np.int32) if loop_top_k is None else loop_top_k]
        self.state, emitted, n_emitted, row_logits, loop_block = ragged_mixed_step(
            self.params, self.state, d(tokens, I32), d(tok_row, I32), d(row_slot, I32),
            d(row_start, I32), d(row_len, I32), d(row_from_device, torch.bool),
            d(row_arm, torch.bool), d(row_n_drafts, I32), d(temperature, torch.float32),
            d(top_p, torch.float32), d(top_k, I32), d(loop_active, torch.bool),
            d(tail[0], torch.float32), d(tail[1], torch.float32), d(tail[2], I32),
            self._eos(eos_id),
            config=self.config, page_size=self.page_size, spec_width=self.engine_cfg.spec_tokens,
            loop_depth=self.decode_loop_depth,
        )
        return emitted, n_emitted, row_logits, loop_block

    def ragged_multi(self, tokens, tok_row, row_slot, row_start, row_len, row_from_device,
                     row_arm, temperature, top_p, top_k, loop_active, loop_temperature,
                     loop_top_p, loop_top_k, eos_id: int):
        """One captured multi-round dispatch (see ragged_multi_round) from
        host arrays: ``tokens.shape[0]`` rounds enqueued back to back,
        returning the token ring ``(ring_tokens, ring_n, ring_blocks)`` as
        device tensors. Counted once at the dispatch seam, which is why
        dispatches a round drop below 1."""
        METRICS.inc("finchat_mixed_dispatches_total")
        self._count_fallback("ragged_multi")
        d = self.to_device
        self.state, ring_tokens, ring_n, ring_blocks = ragged_multi_round(
            self.params, self.state, d(tokens, I32), d(tok_row, I32), d(row_slot, I32),
            d(row_start, I32), d(row_len, I32), d(row_from_device, torch.bool),
            d(row_arm, torch.bool), d(temperature, torch.float32), d(top_p, torch.float32),
            d(top_k, I32), d(loop_active, torch.bool), d(loop_temperature, torch.float32),
            d(loop_top_p, torch.float32), d(loop_top_k, I32), self._eos(eos_id),
            config=self.config, page_size=self.page_size, loop_depth=self.decode_loop_depth,
        )
        return ring_tokens, ring_n, ring_blocks

    def decode_loop(self, active, temperature, top_p, top_k, eos_id: int,
                    depth: int | None = None) -> torch.Tensor:
        """Fused multi-step decode (see decode_loop_step) from host arrays:
        K iterations, sampling and the EOS stop mask on the device. Returns
        the ``[K, max_seqs]`` token block (device; callers fetch once).
        ``depth`` overrides ``decode_loop_depth``. On the card the block is
        a replay of the depth's CUDA graph (captured here at first use, or
        at ``warmup()``); a capture that fails raises, and nothing falls
        back to the eager loop. Counted once at the dispatch seam."""
        K = depth if depth is not None else self.decode_loop_depth
        assert K >= 1
        METRICS.inc("finchat_decode_dispatches_total")
        self._count_fallback("decode_loop")
        d = self.to_device
        args = (d(active, torch.bool), d(temperature, torch.float32),
                d(top_p, torch.float32), d(top_k, I32))
        if self.device.type == "cuda":
            return self._loop_graph(K).replay(*args, eos_id)
        self.state, block = decode_loop_step(self.params, self.state, *args, self._eos(eos_id),
                                             config=self.config, page_size=self.page_size,
                                             loop_depth=K)
        return block

    def decode_spec(self, active, drafts, n_drafts, temperature, top_p, top_k,
                    return_logits: bool = False):
        """The speculative verify step (see verify_step) from host arrays;
        ``drafts`` [B, Kd] sets the shape (callers pad to a fixed Kd).
        Returns ``(emitted, n_emitted)``, with the position-0 logits too
        when ``return_logits``. Counted at the dispatch seam like
        ``decode``."""
        METRICS.inc("finchat_decode_dispatches_total")
        self._count_fallback("verify")
        d = self.to_device
        self.state, emitted, n_emitted, logits = verify_step(
            self.params, self.state, d(active, torch.bool), d(drafts, I32), d(n_drafts, I32),
            d(temperature, torch.float32), d(top_p, torch.float32), d(top_k, I32),
            config=self.config, page_size=self.page_size, return_logits=return_logits,
        )
        return (emitted, n_emitted, logits) if return_logits else (emitted, n_emitted)

    def _eos(self, eos_id: int) -> torch.Tensor:
        """The stop token as the 0-d int32 device tensor the steps take."""
        return self.to_device(np.asarray(eos_id, np.int32))

    def _loop_graph(self, depth: int) -> DecodeLoopGraph:
        """The CUDA graph of ``decode_loop_step`` at ``depth`` over the
        current state, captured on first use."""
        graph = self._loop_graphs.get(depth)
        if graph is None or graph.state is not self.state:
            # never while a sibling engine rebuilds its pool on another thread
            with DEVICE_STATE_LOCK, torch.cuda.device(self.device):
                graph = DecodeLoopGraph(self, depth)
            self._loop_graphs[depth] = graph
        return graph


class DecodeLoopGraph:
    """``decode_loop_step`` at one depth captured as one CUDA graph over an
    engine's state, replayed for every block.

    The body updates ``context_lens``, ``last_tokens`` and the pages in
    place, so every replay reads and writes the state's own storage; the
    block's inputs (active mask, per-slot temperature, ``top_p``,
    ``top_k``, ``eos_id``) are copied into static buffers before each
    replay, and the output block is copied out after it (the next replay
    overwrites the captured one while the scheduler may still be fetching
    it). The state's generator is registered with the graph, so each
    replay draws fresh noise. ``kernels.launch`` counts a launch in Python,
    which a replay does not pass through: the launches the capture recorded
    (and did not run, so they are taken back) are added to
    ``kernels.LAUNCHES`` at every replay. The capture runs one eager block
    first on its side stream (every slot inactive: trash-page writes only),
    as capture wants libraries loaded and workspaces sized. A capture that
    fails raises."""

    def __init__(self, engine: InferenceEngine, depth: int):
        from finchat_tpu_torch.ops import kernels

        self.state = state = engine.state
        self.depth = depth
        B = engine.engine_cfg.max_seqs
        dev = engine.device
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.temperature = torch.ones((B,), dtype=torch.float32, device=dev)
        self.top_p = torch.ones((B,), dtype=torch.float32, device=dev)
        self.top_k = torch.zeros((B,), dtype=I32, device=dev)
        self.eos_id = torch.full((), -1, dtype=I32, device=dev)
        body = dict(config=engine.config, page_size=engine.page_size, loop_depth=depth)
        ins = (self.active, self.temperature, self.top_p, self.top_k, self.eos_id)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            decode_loop_step(engine.params, state, *ins, **body)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(kernels.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
            _, self.block = decode_loop_step(engine.params, state, *ins, **body)
        self.launches = {name: n - before.get(name, 0) for name, n in kernels.LAUNCHES.items()
                         if n != before.get(name, 0)}
        for name, n in self.launches.items():  # the capture ran nothing
            kernels.LAUNCHES[name] -= n
        self._kernels = kernels

    def replay(self, active: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor,
               top_k: torch.Tensor, eos_id: int) -> torch.Tensor:
        """One block: copy the inputs in, replay, return a copy of the
        ``[K, max_seqs]`` block (all on the current stream, no host sync)."""
        self.active.copy_(active)
        self.temperature.copy_(temperature)
        self.top_p.copy_(top_p)
        self.top_k.copy_(top_k)
        self.eos_id.fill_(int(eos_id))
        self.graph.replay()
        for name, n in self.launches.items():
            self._kernels.LAUNCHES[name] += n
        return self.block.clone()
