"""Inference engine: prefill/decode step functions over the paged KV cache.

Shape discipline follows the JAX package, so the two compare like with
like:

- ``prefill_step``: ``N x prefill_chunk`` tokens — N sequences advance one
  chunk together (the scheduler pads N to a power of two); exhausted
  prompts ride with ``n_valid = 0`` and write the trash page.
- ``decode_step``: the full ``max_seqs`` slot batch every step; inactive
  slots write the trash page.
- ``ragged_mixed_step``: ONE packed ragged dispatch advancing every
  prefilling sequence a chunk and every decoding slot a token — rows of a
  packed token buffer (ops/ragged_paged_attention.py) padded to a pow-2
  bucket, each row with its own length, page list and sampling params.
  Spec-verify rows and fused loop tails are later slices.

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from finchat_tpu_torch.engine.kv_cache import PagedKVCache
from finchat_tpu_torch.engine.sampler import sample
from finchat_tpu_torch.models.llama import LlamaConfig, forward, lm_head
from finchat_tpu_torch.models.quant import quantize_llama_params, validate_quant_mode
from finchat_tpu_torch.ops.dispatch import kv_write, paged_attention, ragged_paged_attention
from finchat_tpu_torch.ops.kv_append import plan_kv_rows, plan_kv_rows_ragged
from finchat_tpu_torch.ops.ragged_paged_attention import plan_ragged
from finchat_tpu_torch.utils.config import EngineConfig
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS

logger = get_logger(__name__)

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
    per slot; this port does not carry bounded KV yet, so it stays zero and
    every compacted expression reduces to the absolute one. ``generator``
    is the sampling noise source (the JAX package's ``rng`` key)."""

    k_pages: torch.Tensor  # [L, P, page_size, Hkv*hd] (model dtype, or int8)
    v_pages: torch.Tensor
    k_scales: torch.Tensor | None  # [L, P, scale_rows, page_size] fp32, int8 cache only
    v_scales: torch.Tensor | None
    page_table: torch.Tensor  # [max_seqs, max_pages_per_seq] int32 (0 = trash)
    context_lens: torch.Tensor  # [max_seqs] int32 — tokens seen (rotary)
    last_tokens: torch.Tensor  # [max_seqs] int32 — next decode input per slot
    kv_gaps: torch.Tensor  # [max_seqs] int32 — always 0 in this slice
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
    own tokens."""
    kv_len = (start_pos + n_valid).to(I32)
    kv_rows = plan_kv_rows(page_table, start_pos, n_valid, chunk, page_size)

    def attention(q, k, v, cache, layer_idx: int):
        k_pages, v_pages, k_scales, v_scales = cache
        scales = dict(k_scales=k_scales, v_scales=v_scales)
        N = k.shape[0] * k.shape[1]
        kv_write(kv_rows, k.reshape(N, -1), v.reshape(N, -1), k_pages, v_pages, layer_idx,
                 n_kv=n_kv, **scales)
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
    attention = _paged_attention_fn(
        page_rows, (start_pos - state.kv_gaps[slots_l]).to(I32), n_valid, C,
        page_size, config.n_kv_heads,
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
    tokens = state.last_tokens[:, None]
    positions = state.context_lens[:, None]
    n_valid = active.to(I32)
    attention = _paged_attention_fn(
        state.page_table, (state.context_lens - state.kv_gaps).to(I32), n_valid, 1,
        page_size, config.n_kv_heads,
    )
    logits, _ = forward(params, tokens, positions, config=config, attention=attention,
                        cache=_cache(state))
    step_logits = logits[:, 0, :]
    next_tokens = sample(step_logits, state.generator, temperature, top_p, top_k)
    state.context_lens = (state.context_lens + n_valid).to(I32)
    state.last_tokens = torch.where(active, next_tokens, state.last_tokens)
    return state, next_tokens, (step_logits if return_logits else None)


def _ragged_attention_fn(
    page_rows: torch.Tensor,  # [R, max_pages] per-ROW page lists
    tok_row: torch.Tensor,  # [T] int32 — owning row per packed token (R = padding)
    tok_pos: torch.Tensor,  # [T] int32 — absolute position per packed token
    row_kv_len: torch.Tensor,  # [R] int32 — valid KV per row incl. this dispatch
    page_size: int,
    n_kv: int,
    group: int,  # query heads per KV head
    row_gap: torch.Tensor,  # [R] int32 — bounded-KV eviction gap (0 here)
):
    """Attention callback for the packed ragged step: every packed token's
    K/V row lands at its own compacted position through its row's page list
    (padding tokens write the trash page), then the ragged attention reads
    each row's pages in place. The round's descriptors (compacted positions
    and lengths, tiles, rows) and its KV rows are built here once and
    shared by every layer's call, over either cache."""
    plan = plan_ragged(tok_row, tok_pos, row_kv_len, group=group, kv_gap=row_gap)
    kv_rows = plan_kv_rows_ragged(page_rows, tok_row, plan.tok_pos, page_size)

    def attention(q, k, v, cache, layer_idx: int):
        k_pages, v_pages, k_scales, v_scales = cache
        T = k.shape[1]
        kv_write(kv_rows, k.reshape(T, -1), v.reshape(T, -1), k_pages, v_pages, layer_idx,
                 n_kv=n_kv, k_scales=k_scales, v_scales=v_scales)
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
    #   row starts at context_lens[slot] (decode rows)
    row_arm: torch.Tensor,  # [R] bool — commit this row's sampled token to last_tokens
    temperature: torch.Tensor,  # [R] — PER-ROW sampling params
    top_p: torch.Tensor,  # [R]
    top_k: torch.Tensor,  # [R] int32
    *,
    config: LlamaConfig,
    page_size: int,
) -> tuple[DecodeState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The packed ragged round body for plain rows (prefill chunks and
    1-token decode rows): see ``ragged_mixed_step``."""
    T = tokens.shape[0]
    R = row_slot.shape[0]
    dev = tokens.device
    slot_l = row_slot.long()
    tok_row = tok_row.to(I32)
    safe_row = tok_row.long().clamp(max=R - 1)
    tok_valid = tok_row < R
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
                                     config.n_kv_heads, config.n_heads // config.n_kv_heads,
                                     row_gap)
    hidden, _ = forward(params, tok_in[None], tok_pos[None], config=config,
                        attention=attention, cache=_cache(state), return_hidden=True)
    h = hidden[0]  # [T, D]
    last_off = (row_len - 1).clamp(min=0)
    sel_idx = (q_start + last_off).clamp(0, T - 1).long()
    row_logits = lm_head(params, h[sel_idx], config=config)  # [R, vocab] fp32
    sampled = sample(row_logits, state.generator, temperature, top_p, top_k)
    emitted = sampled[:, None]
    n_emitted = row_arm.to(I32)
    delta = torch.where(row_arm, sampled - row_last, torch.zeros_like(sampled))
    state.context_lens.index_add_(0, slot_l, row_len.to(I32))
    state.last_tokens.index_add_(0, slot_l, delta.to(I32))
    return state, emitted, n_emitted, row_logits


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
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    *,
    config: LlamaConfig,
    page_size: int,
) -> tuple[DecodeState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """ONE packed ragged dispatch advancing every prefilling row a chunk and
    every decoding row a token. Returns ``(state, emitted [R, 1], n_emitted
    [R], row_logits [R, vocab])``.

    - Device-read rows (``row_from_device``) take their first token from
      ``state.last_tokens[slot]`` and start at ``context_lens[slot]`` on the
      device.
    - Each row samples at its last valid token with its own params; armed
      rows (decode rows, and prefill rows whose prompt completes) commit the
      sample to ``last_tokens`` as a DELTA add, so duplicate-slot padding
      rows (delta 0) cannot race the real row's write.
    - Context advances by each row's packed length (0 for padding rows).
    """
    return _ragged_round_math(
        params, state, tokens, tok_row, row_slot, row_start, row_len,
        row_from_device, row_arm, temperature, top_p, top_k,
        config=config, page_size=page_size,
    )


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
    int8 with scale planes."""

    def __init__(self, config: LlamaConfig, params: dict[str, Any], engine_cfg: EngineConfig,
                 device: str | torch.device = "cuda", quant: str = "", quant_group: int = 0):
        validate_quant_mode(quant)
        device = torch.device(device)
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
        if quant:
            params = quantize_llama_params(params, mode=quant, group_size=quant_group)
        self.config = config
        self.params = params
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

    def set_last_token(self, slot: int, token: int) -> None:
        """Override a slot's next decode input."""
        self.state.last_tokens[slot] = int(token)

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

    # --- steps -----------------------------------------------------------
    def prefill_chunk(self, tokens, slots, start_pos, n_valid) -> torch.Tensor:
        """One batched prefill chunk from host arrays; returns the
        last-valid-token logits [N, vocab] (device)."""
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
        Exhausted prompts ride the remaining rounds with ``n_valid = 0``."""
        assert items, "empty prefill batch"
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

    def commit_first_token(self, slot: int, logits: torch.Tensor, temperature: float,
                           top_p: float, top_k: int) -> torch.Tensor:
        self.state, token = commit_first_token(self.state, slot, logits, temperature,
                                               top_p, top_k)
        return token

    def decode(self, active, temperature, top_p, top_k, return_logits: bool = False):
        """One decode step from host arrays; returns next tokens (device),
        with the step logits too when ``return_logits``."""
        METRICS.inc("finchat_decode_dispatches_total")
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
                     row_from_device, row_arm, temperature, top_p, top_k):
        """One packed ragged dispatch (see ragged_mixed_step) from host
        arrays; returns ``(emitted, n_emitted, row_logits)`` device tensors."""
        METRICS.inc("finchat_mixed_dispatches_total")
        d = self.to_device
        self.state, emitted, n_emitted, row_logits = ragged_mixed_step(
            self.params, self.state, d(tokens, I32), d(tok_row, I32), d(row_slot, I32),
            d(row_start, I32), d(row_len, I32), d(row_from_device, torch.bool),
            d(row_arm, torch.bool), d(temperature, torch.float32), d(top_p, torch.float32),
            d(top_k, I32),
            config=self.config, page_size=self.page_size,
        )
        return emitted, n_emitted, row_logits
