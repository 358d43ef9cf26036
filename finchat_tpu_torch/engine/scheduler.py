"""Continuous-batching scheduler (the core of the JAX package's scheduler).

Many sequences multiplexed onto one model replica:

- Admission: pending sequences are admitted when a slot AND enough KV pages
  for prompt + max_new_tokens are available (no mid-flight OOM).
- Batched chunked prefill interleaved with decode: each loop iteration runs
  ONE prefill round — every prefilling sequence advances one chunk in a
  single [N, chunk] ``prefill_step`` (N padded to a power of two) — then
  one decode step for all active slots.
- Pipelined decode: decode step N+1 is enqueued on the device BEFORE step
  N's tokens are fetched, and every device->host fetch runs in a worker
  thread, so the asyncio loop never blocks on the card. A sequence that
  hits EOS at step N wastes one speculative token at N+1; the host
  discards it.
- Unified packed ragged step (``engine.mixed_step``, default on): when
  prefill work and in-flight decodes coexist, the iteration runs ONE
  ``ragged_mixed_step`` dispatch over a packed token buffer — every
  prefilling row advances a chunk and every decoding row a token — instead
  of a prefill round plus a decode step. ``finchat_coexist_iterations_total``
  counts those iterations and ``finchat_coexist_dispatches_total`` the model
  dispatches booked to them.
- Per-sequence failure isolation: an errored sequence is evicted, its pages
  freed, an error event emitted on its stream; a whole-round failure evicts
  that round's population, and the engine keeps serving the others.
- Shared-prefix KV cache (``prefix_cache``): ``register_prefix`` prefills a
  constant prompt head (the system prompt every conversation repeats) ONCE
  into pages of its own; admission points a matching prompt's page table at
  those whole pages, read-only and refcounted, and prefills only the rest.
  ``register_prefix_async`` registers on a running scheduler, the head
  riding the prefill and ragged rounds a chunk at a time as a row that
  samples nothing; ``retire_prefixes`` stops matching and frees the pages
  once the last reference goes.
- Session KV cache (``session_cache``, engine/session_cache.py): a
  sequence that retires normally and carries a ``conversation_id`` has its
  own pages snapshotted to the host before they are freed; the
  conversation's next turn restores the matched pages and prefills only
  the new tokens. A RAM miss falls through to the disk tier when
  ``session_cache_disk_path`` is set.
- Resilience: recompute preemption (``_preempt`` frees a victim's slot and
  KV pages but keeps prompt and generated tokens on the handle; the replay
  re-prefills its history and resumes with no duplicate or dropped token),
  used for page pressure (``preemption``: the latest-deadline victim yields
  to a strictly earlier-deadline candidate) and as the recovery primitive
  of the engine circuit breaker (``breaker_threshold`` consecutive failed
  rounds of a plane preempt every live sequence, rebuild the engine's
  device state with the weights kept, and replay; ``breaker_max_rebuilds``
  trips without a successful round in between give up and fail the
  streams). Deadline admission: pending requests past their deadline are
  shed with a structured retryable error, admission runs earliest deadline
  first with a starvation guard (``edf_starvation_seconds``), and
  ``submit`` raises ``OverloadedError`` above ``max_queue_depth``. Every
  dispatch records its members with their admission epoch, which a
  preemption bumps, so a replay never receives a token of a step that was
  in flight when it was preempted.
- Grammar-constrained decoding (``submit(..., constraint=)``, the agent's
  tool decision): a constrained slot's token is picked on the host from
  its logits row under the grammar mask (``agent/constrained.py``) and
  written back as the slot's next decode input. Only the constrained rows'
  logits leave the card, selected there first. The prefill round picks a
  completion's first token, the ragged round brings back the rows of its
  constrained completions and decode rows, and in the depth-2 pipelined
  decode a slot whose pick is still pending sits out the next dispatch;
  when every decoding slot waits on a pick, the loop drains and runs
  depth-1.
- Partial holds, the retrieval/prefill overlap (``submit_partial``,
  ``extend_prompt``): a prompt's static prefix prefills while its tail is
  still being retrieved and parks, owning its slot and pages, without a
  first token; the graft appends the full prompt and prefill goes on from
  the parked position. A parked hold is no work (an idle loop sleeps), and
  one never grafted is reaped after ``partial_hold_ttl_seconds``.
- Request tracing (utils/tracing.py): every handle carries a
  ``RequestSpan`` (marks ``admitted``, ``prefill_done``, ``first_token``,
  ``done``, finished once at every terminal site), every dispatch records
  its ``[slot, trace_id, mode]`` rows while ``TRACER.enabled``, and a shed,
  a breaker trip and a give-up dump the flight recorder.

The serving planes this port does not carry yet — speculative decode, the
fused decode loop, the free-running loop and bounded KV — are refused at
construction (``check_supported``) instead of being silently ignored. The
quantized plane (int8/int4 weights, int8 KV pages) is served: the
scheduler keeps the engine's quant label and sets the
``finchat_quant_weight_bits`` / ``finchat_quant_kv_bits`` gauges.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from finchat_tpu_torch.engine.engine import InferenceEngine, round_up_pow2
from finchat_tpu_torch.engine.kv_cache import PageAllocator, pages_needed
from finchat_tpu_torch.engine.sampler import CANDIDATES, SamplingParams
from finchat_tpu_torch.engine.session_cache import (
    SessionDiskTier,
    SessionEntry,
    SessionKVCache,
    concat_snaps,
    snap_kv_mode,
)
from finchat_tpu_torch.utils.config import EngineConfig
from finchat_tpu_torch.utils.faults import inject
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS, Timer
from finchat_tpu_torch.utils.tracing import TRACER, RequestSpan

if TYPE_CHECKING:  # the engine does not import the agent layer at run time
    from finchat_tpu_torch.agent.constrained import TokenConstraint

logger = get_logger(__name__)


def check_supported(cfg: EngineConfig) -> None:
    """Raise on a config that turns on a serving plane this port does not
    carry yet (each is a later slice)."""
    unsupported = {
        "spec_tokens > 0": cfg.spec_tokens > 0,
        "decode_loop_depth > 1": cfg.decode_loop_depth > 1,
        "freerun_rounds > 1": cfg.freerun_rounds > 1,
        "bounded KV (kv_sink_pages / kv_window_pages)":
            cfg.kv_sink_pages > 0 or cfg.kv_window_pages > 0,
    }
    on = [name for name, flag in unsupported.items() if flag]
    if on:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(on) + " (turn these off in EngineConfig)"
        )


class OverloadedError(RuntimeError):
    """``submit`` rejected: the admission queue is at ``max_queue_depth``.
    Retryable by contract: the serving layer surfaces it as a structured
    retryable error."""

    code = "overloaded"
    retryable = True


@dataclass
class SequenceHandle:
    """Host-side record of one in-flight sequence; ``events`` receives
    ``{"type": "token", "token_id": int}``, then one terminal
    ``{"type": "done", "reason": ...}`` or ``{"type": "error", ...}``."""

    seq_id: str
    prompt_ids: list[int]
    sampling: SamplingParams
    # the grammar cursor of a constrained decode (None = unconstrained)
    constraint: TokenConstraint | None = None
    # session KV cache key: turns of one conversation resume each other's
    # KV (engine/session_cache.py); None = no cross-turn caching
    conversation_id: str | None = None
    events: asyncio.Queue = field(default_factory=asyncio.Queue)
    slot: int = -1
    prefill_pos: int = 0  # prompt tokens already prefilled
    # the slot's logical -> physical page list from admission: shared head
    # pages first, then its own (retirement offload slices it)
    page_list: list[int] = field(default_factory=list)
    # tokens in READ-ONLY referenced head pages; the slot's writes start here
    shared_len: int = 0
    # tokens restored from a session snapshot at admission (0 = cold): the
    # pages of [shared_len, resumed_len) are never rewritten, so retirement
    # reuses the previous entry's host bytes for them
    resumed_len: int = 0
    # the shared-prefix entry the page table references (refcounted)
    prefix_entry: object | None = None
    # completion deadline on time.perf_counter's clock; None = none. A
    # pending entry past it is shed, admission runs earliest deadline
    # first, and page pressure preempts the latest-deadline victim
    deadline: float | None = None
    # recompute preemptions survived (page pressure, breaker recovery)
    preempted: int = 0
    # admission epoch, bumped by _preempt: a dispatch records (slot,
    # handle, epoch), so a replay re-admitted into the same slot is told
    # apart from the incarnation the dispatch was built for
    epoch: int = 0
    # the scheduler driving this handle (rebound by adopt); cancel()
    # delegates to it
    owner: object | None = None
    # retrieval/prefill overlap (submit_partial): ``prompt_ids`` is only the
    # prompt's static prefix; it prefills, then parks without a first token
    # until extend_prompt grafts the full prompt (or the hold goes stale at
    # ``held_deadline`` and is reaped)
    held: bool = False
    held_deadline: float = 0.0
    # the hold was extended into a full prompt
    grafted: bool = False
    generated: int = 0
    history: list[int] = field(default_factory=list)  # prompt + delivered tokens
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: float | None = None
    last_token_at: float | None = None
    finished: bool = False
    # end-to-end trace id (utils/tracing.py); None = untraced
    trace_id: str | None = None
    span: RequestSpan = None  # type: ignore[assignment]  # set in __post_init__

    def __post_init__(self) -> None:
        if self.span is None:
            self.span = RequestSpan(self.seq_id, trace_id=self.trace_id)
        if not self.history:
            self.history = list(self.prompt_ids)

    def _emit_first_token_metrics(self) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.perf_counter()
            self.span.mark("first_token")
            METRICS.observe("finchat_ttft_seconds", self.first_token_at - self.submitted_at,
                            trace_id=self.trace_id)


@dataclass
class _InFlightStep:
    """A dispatched-but-unconsumed decode step: device tokens, the logits
    rows of its constrained members (selected on the device, in
    ``constrained_slots`` order), and the membership snapshot it was
    dispatched against, each member with its admission epoch."""

    tokens: object  # [max_seqs] int32, device
    logits: object | None  # [n_constrained, vocab] fp32, device, or None
    members: list[tuple[int, SequenceHandle, int]]
    constrained_slots: list[int]


@dataclass
class _PrefixJob:
    """A chunked prefix registration in progress (``register_prefix_async``):
    the head prefills one chunk per round as a row of the prefill or
    ragged round that samples nothing, so decode keeps going. Owns its
    pages and an engine slot until it completes (entry published) or fails
    (pages freed, future resolves to 0)."""

    ids: list[int]
    shared_len: int
    owner: str
    pages: list[int]
    slot: int
    future: asyncio.Future
    pos: int = 0


@dataclass
class _PrefixEntry:
    """One registered shared prompt head: its token ids, the pages holding
    its KV, and a live-reference count, so retirement frees the pages only
    once no page table and no session entry points at them."""

    ids: list[int]
    pages: list[int]
    shared_len: int
    owner: str
    refs: int = 0
    retired: bool = False


class ContinuousBatchingScheduler:
    def __init__(self, engine: InferenceEngine, eos_id: int):
        cfg = engine.engine_cfg
        check_supported(cfg)
        self.engine = engine
        self.eos_id = eos_id
        self.metrics = METRICS
        self.allocator = PageAllocator(cfg.num_pages)
        self.free_slots: list[int] = list(range(cfg.max_seqs))
        self.pending: deque[SequenceHandle] = deque()
        self.prefilling: deque[SequenceHandle] = deque()
        self.decoding: dict[int, SequenceHandle] = {}  # slot -> handle
        B = cfg.max_seqs
        self._temperature = np.zeros((B,), np.float32)
        self._top_p = np.ones((B,), np.float32)
        self._top_k = np.zeros((B,), np.int32)
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._running = False
        self._rng = np.random.default_rng(0)  # the host-side constrained picks
        # a partial hold not grafted within this many seconds has lost its
        # owner: it is reaped (partial_hold_ttl_seconds)
        self.hold_ttl_s = max(0.0, cfg.partial_hold_ttl_seconds)
        # the track of this engine's events on a trace timeline
        self._trace_track = "engine"
        self.mixed_enabled = bool(cfg.mixed_step)
        self.max_queue_depth = max(0, cfg.max_queue_depth)
        # whether the current loop iteration ran prefill work (the
        # finchat_inter_token_seconds label)
        self._iter_ran_prefill = False
        # every model dispatch bumps _dispatch_tally; the span from one
        # coexist iteration's start to the next accounting point lands in
        # finchat_coexist_dispatches_total
        self._dispatch_tally = 0
        self._coexist_mark: int | None = None
        self._top_k_clamp_warned: set[int] = set()
        # the quantized serving plane: the engine's mode as one label, and
        # bits per weight / per KV element as gauges (the model dtype's
        # width when that side is not quantized)
        self.quant_label = engine.quant_label
        elem_bits = 8 * engine.config.dtype.itemsize
        self.metrics.set_gauge("finchat_quant_weight_bits",
                               {"int8": 8, "int4": 4}.get(engine.quant, elem_bits))
        self.metrics.set_gauge("finchat_quant_kv_bits", 8 if engine.kv_quant else elem_bits)
        self.metrics.inc("finchat_quant_dequant_fallbacks_total", 0.0)
        # shared-prefix KV cache: registered heads and registrations in flight
        self._prefixes: list[_PrefixEntry] = []
        self._n_prefixes_ever = 0  # unique allocator owner ids
        self._prefix_jobs: deque[_PrefixJob] = deque()
        # --- resilience --------------------------------------------------
        # the breaker: consecutive whole-round failures per plane ("prefill"
        # / "decode"; the ragged round rides "decode") before it trips and
        # the device state is rebuilt; 0 turns it off (a failed round then
        # evicts its sequences with an error)
        self.breaker_threshold = max(0, cfg.breaker_threshold)
        self.breaker_max_rebuilds = max(1, cfg.breaker_max_rebuilds)
        self.preemption_enabled = bool(cfg.preemption)
        self.edf_starvation_s = max(0.0, cfg.edf_starvation_seconds)
        self._fail_streaks = {"prefill": 0, "decode": 0}
        self._rebuilds_without_success = 0
        self._breaker_tripped_at: float | None = None
        # the plane that tripped the breaker: only a successful round of it
        # closes the breaker (a decode-wedged engine still prefills fine)
        self._breaker_bucket: str | None = None
        # callbacks after a rebuild (the serving layer re-registers its
        # shared heads: the rebuild dropped them) and after a give-up
        self.on_rebuild: list = []
        self.on_give_up: list = []
        # True from a give-up until revive_async()
        self.gave_up = False
        # True while a trip's rebuild runs in its worker thread: the rebuild
        # replaces the page table, so register_prefix_async must not write a
        # row into the table being dropped
        self._rebuilding = False
        # 0 closed, 1 open (rebuilding), 2 half-open (rebuilt, waiting for
        # the first successful round)
        self.metrics.set_gauge("finchat_breaker_state", 0)
        # session KV cache: the host-RAM tier (None = off), with the disk
        # tier below it when a path is set; on_drop releases an entry's
        # reference on its shared head
        self.session_cache: SessionKVCache | None = None
        if cfg.session_cache and cfg.session_cache_bytes > 0:
            disk = None
            if cfg.session_cache_disk_path:
                try:
                    disk = SessionDiskTier(cfg.session_cache_disk_path,
                                           cfg.session_cache_disk_bytes, metrics=self.metrics,
                                           kv_quant=engine.kv_quant)
                except OSError as e:  # durability is best-effort
                    logger.error("session disk tier unavailable at %s: %s",
                                 cfg.session_cache_disk_path, e)
            self.session_cache = SessionKVCache(
                cfg.session_cache_bytes, page_size=cfg.page_size, on_drop=self._session_drop,
                metrics=self.metrics, disk=disk)

    # --- public API -----------------------------------------------------
    async def start(self) -> None:
        self._wakeup = asyncio.Event()  # rebind to the current loop
        self._running = True
        # the engine's step-variant count from its last warmup (0 = none)
        self.metrics.set_gauge("finchat_warmup_compiled_variants",
                               self.engine.compiled_variants)
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        self._running = False
        self._wakeup.set()
        if self._task:
            await self._task
        for job in list(self._prefix_jobs):  # stopped mid-registration
            self._fail_prefix_job(job)

    async def submit(self, seq_id: str, prompt_ids: list[int], sampling: SamplingParams,
                     constraint: TokenConstraint | None = None,
                     conversation_id: str | None = None,
                     deadline: float | None = None,
                     trace_id: str | None = None) -> SequenceHandle:
        """Queue a sequence. ``constraint`` makes its decode grammar-
        constrained (the generator builds it from ``sampling.grammar``; a
        grammar with no constraint is served unconstrained, as in the
        reference). ``deadline`` (on ``time.perf_counter``'s clock) feeds
        shedding and earliest-deadline-first admission. ``trace_id`` puts the
        request on a trace timeline."""
        if not prompt_ids:
            raise ValueError("empty prompt")
        if self.max_queue_depth > 0 and len(self.pending) >= self.max_queue_depth:
            # backpressure: new load above the bound is refused, retryable
            # (preempted sequences bypass submit: they are live streams)
            self.metrics.inc("finchat_overload_rejections_total")
            raise OverloadedError(
                f"admission queue full ({len(self.pending)} >= "
                f"{self.max_queue_depth}); retry with backoff"
            )
        max_len = self.engine.max_pages_per_seq * self.engine.page_size
        if len(prompt_ids) + sampling.max_new_tokens > max_len:
            raise ValueError(
                f"sequence {seq_id}: prompt {len(prompt_ids)} + max_new "
                f"{sampling.max_new_tokens} exceeds max length {max_len}"
            )
        if sampling.top_k > CANDIDATES:
            if sampling.top_k not in self._top_k_clamp_warned:
                self._top_k_clamp_warned.add(sampling.top_k)
                logger.warning("sequence %s: top_k=%d exceeds the sampler candidate cap "
                               "%d; clamping", seq_id, sampling.top_k, CANDIDATES)
            self.metrics.inc("finchat_top_k_clamped_total")
            sampling = dataclasses.replace(sampling, top_k=CANDIDATES)
        handle = SequenceHandle(seq_id=seq_id, prompt_ids=list(prompt_ids), sampling=sampling,
                                constraint=constraint, conversation_id=conversation_id,
                                deadline=deadline, owner=self, trace_id=trace_id)
        self.pending.append(handle)
        self.metrics.set_gauge("finchat_queue_depth", len(self.pending))
        self._wakeup.set()
        return handle

    async def submit_partial(self, seq_id: str, prefix_ids: list[int], sampling: SamplingParams,
                             conversation_id: str | None = None,
                             deadline: float | None = None,
                             trace_id: str | None = None) -> SequenceHandle | None:
        """Start prefilling a prompt whose tail is not known yet (the
        retrieval/prefill overlap): ``prefix_ids`` is the static leading part
        of the final prompt. The sequence admits and prefills as usual but
        parks when the prefix is done instead of sampling a first token;
        ``extend_prompt`` grafts the full prompt in and prefill goes on from
        the parked position. Returns None when the prefix cannot ride this
        path (empty, or over budget); the caller then submits the full
        prompt."""
        if not prefix_ids:
            return None
        max_len = self.engine.max_pages_per_seq * self.engine.page_size
        if len(prefix_ids) + sampling.max_new_tokens > max_len:
            return None  # the full prompt could never fit either
        handle = await self.submit(seq_id, prefix_ids, sampling,
                                   conversation_id=conversation_id, deadline=deadline,
                                   trace_id=trace_id)
        # no await ran between submit() queueing the handle and here (the
        # loop is another task), so admission sees the hold flags set
        handle.held = True
        handle.held_deadline = time.perf_counter() + self.hold_ttl_s
        self.metrics.inc("finchat_partial_holds_total")
        return handle

    def extend_prompt(self, handle: SequenceHandle, full_ids: list[int]) -> bool:
        """Graft the full prompt onto a parked or prefilling hold. Returns
        False, leaving the hold as it was (the caller cancels it and submits
        the full prompt), when the graft would invalidate what was
        prefilled (``full_ids`` does not extend the held prefix) or the
        extra KV pages cannot be had. A hold over a shared head counts the
        head's pages in its page list, so only the pages past it are
        allocated."""
        if handle.finished or not handle.held:
            return False
        prefix = handle.prompt_ids
        if len(full_ids) <= len(prefix) or full_ids[: len(prefix)] != prefix:
            self.metrics.inc("finchat_partial_fallbacks_total")
            return False
        max_len = self.engine.max_pages_per_seq * self.engine.page_size
        if len(full_ids) + handle.sampling.max_new_tokens > max_len:
            self.metrics.inc("finchat_partial_fallbacks_total")
            return False
        if handle.slot >= 0:
            total = pages_needed(len(full_ids) + handle.sampling.max_new_tokens,
                                 self.engine.page_size)
            extra = total - len(handle.page_list)
            if extra > 0:
                if (total > self.engine.max_pages_per_seq
                        or not self.allocator.can_allocate(extra)):
                    self.metrics.inc("finchat_partial_fallbacks_total")
                    return False
                new_pages = self.allocator.allocate(handle.seq_id, extra)
                handle.page_list = handle.page_list + new_pages
                self.engine.set_page_table_rows({handle.slot: handle.page_list})
        handle.prompt_ids = list(full_ids)
        handle.history = list(full_ids)
        handle.held = False
        handle.grafted = True
        self.metrics.inc("finchat_partial_grafts_total")
        self._wakeup.set()
        return True

    def cancel(self, handle: SequenceHandle) -> None:
        """Client went away: evict and free."""
        if handle.finished:
            return
        if handle.owner is not None and handle.owner is not self:
            # adopted by another scheduler: its slot and pages live there
            handle.owner.cancel(handle)
            return
        if handle in self.pending:
            self.pending.remove(handle)
            self._finish(handle, "cancelled")
            return
        self._evict(handle, "cancelled")

    # --- shared-prefix KV cache -------------------------------------------
    def register_prefix(self, prompt_ids: list[int]) -> int:
        """Prefill a shared prompt head ONCE and serve its KV to every later
        request that starts with it (the system prompt is identical for
        every conversation). Shares whole pages only — a partly filled page
        would be written by the owning sequence's appends — and the
        remainder prefills per request. Returns the shared token length (0 =
        nothing registered). Call while the engine is idle (startup);
        ``register_prefix_async`` registers on a running scheduler."""
        prep = self._prefix_prep(prompt_ids)
        if not isinstance(prep, tuple):
            return prep  # 0 (unregistrable) or an existing entry's length
        ids, shared_len, owner, pages, slot = prep
        try:
            self.engine.set_page_table_row(slot, pages)
            self.engine.prefill(slot, ids)  # fills exactly the shared pages
        except Exception:
            self.allocator.free(owner, pages)
            raise
        finally:
            try:
                self.engine.reset_slot(slot)
            except Exception as e:  # the slot must come back regardless
                logger.error("slot reset failed after prefix prefill: %s", e)
            self.free_slots.append(slot)
        self._prefixes.append(_PrefixEntry(ids, pages, shared_len, owner))
        logger.info("prefix cache: registered %d shared tokens (%d pages)",
                    shared_len, len(pages))
        return shared_len

    def _prefix_prep(self, prompt_ids: list[int]):
        """What both registrations share: size the whole-page head, dedupe
        against live entries and jobs, reserve pages and an engine slot.
        Returns an int (0 = unregistrable or no capacity, or a registered
        entry's shared length) or ``(ids, shared_len, owner, pages, slot)``."""
        page = self.engine.page_size
        n_pages = min(len(prompt_ids) // page, self.engine.max_pages_per_seq)
        if n_pages <= 0:
            return 0
        shared_len = n_pages * page
        ids = list(prompt_ids[:shared_len])
        for entry in self._prefixes:
            if not entry.retired and entry.shared_len == shared_len and entry.ids == ids:
                return shared_len  # already registered
        for job in self._prefix_jobs:
            if job.shared_len == shared_len and job.ids == ids:
                return 0  # registration already in flight; the caller may retry
        if not self.allocator.can_allocate(n_pages) or not self.free_slots:
            logger.warning("prefix cache: no pages/slot free; not registering")
            return 0
        owner = f"__prefix_{self._n_prefixes_ever}__"
        self._n_prefixes_ever += 1
        pages = self.allocator.allocate(owner, n_pages)
        slot = self.free_slots.pop()
        return ids, shared_len, owner, pages, slot

    async def register_prefix_async(self, prompt_ids: list[int]) -> int:
        """``register_prefix`` for a RUNNING scheduler: the head prefills one
        chunk per round instead of one monolithic prefill, so in-flight
        decode keeps advancing. Resolves to the shared token length, 0 on
        failure (registration is best-effort)."""
        if not self._running:
            return self.register_prefix(prompt_ids)  # engine idle: inline
        if self._rebuilding:
            # a trip's rebuild is replacing the page table in a worker
            # thread: a row written now would be lost. Best-effort: 0, and
            # the caller registers again after the rebuild (on_rebuild)
            return 0
        prep = self._prefix_prep(prompt_ids)
        if not isinstance(prep, tuple):
            return prep
        ids, shared_len, owner, pages, slot = prep
        job = _PrefixJob(ids=ids, shared_len=shared_len, owner=owner, pages=pages, slot=slot,
                         future=asyncio.get_running_loop().create_future())
        try:
            self.engine.set_page_table_row(slot, pages)
        except Exception:
            # return the reservation: a transient device error must not leak it
            self.allocator.free(owner, pages)
            self.free_slots.append(slot)
            raise
        self._prefix_jobs.append(job)
        self._wakeup.set()
        return await job.future

    def _fail_prefix_job(self, job: _PrefixJob) -> None:
        self._prefix_jobs.remove(job)
        self.allocator.free(job.owner, job.pages)
        try:
            self.engine.reset_slot(job.slot)
        except Exception as e:  # the device may be why the job failed
            logger.error("reset_slot during prefix-job failure: %s", e)
        # the slot comes back and the future resolves regardless, or the
        # awaiter of register_prefix_async would hang
        self.free_slots.append(job.slot)
        if not job.future.done():
            job.future.set_result(0)

    def _complete_prefix_job(self, job: _PrefixJob, how: str) -> None:
        """A chunked registration finished its last chunk: publish the
        entry, return the engine slot, resolve the caller's future (shared
        by the prefill and ragged rounds)."""
        self._prefix_jobs.remove(job)
        self.engine.reset_slot(job.slot)
        self.free_slots.append(job.slot)
        self._prefixes.append(_PrefixEntry(job.ids, job.pages, job.shared_len, job.owner))
        logger.info("prefix cache: registered %d shared tokens (%d pages, %s)",
                    job.shared_len, len(job.pages), how)
        if not job.future.done():
            job.future.set_result(job.shared_len)

    def retire_prefixes(self) -> None:
        """Stop matching every registered prefix (the caller is about to
        register fresh heads). Pages free at once when unreferenced, else
        when the last sequence using them releases. Session entries
        referencing a retired head are dropped too: they could never resume
        again, and would pin the head's pages."""
        for entry in self._prefixes:
            entry.retired = True
        if self.session_cache is not None:
            self.session_cache.discard_if(
                lambda e: e.prefix_entry is not None and e.prefix_entry.retired)
        self._reap_prefixes()

    def _reap_prefixes(self) -> None:
        for entry in list(self._prefixes):
            if entry.retired and entry.refs == 0:
                self.allocator.free(entry.owner, entry.pages)
                self._prefixes.remove(entry)

    def _match_prefix(self, prompt_ids: list[int]) -> tuple[_PrefixEntry | None, int]:
        """Longest live registered prefix usable for this prompt: whole
        shared pages only, and at least one prompt token left to prefill
        (the first token needs real last-token logits)."""
        page = self.engine.page_size
        cap = ((len(prompt_ids) - 1) // page) * page
        best: tuple[_PrefixEntry | None, int] = (None, 0)
        for entry in self._prefixes:
            if entry.retired:
                continue
            usable = min(entry.shared_len, cap)
            if usable > best[1] and prompt_ids[:usable] == entry.ids[:usable]:
                best = (entry, usable)
        return best

    # --- internals ------------------------------------------------------
    @staticmethod
    def _remaining_new(handle: SequenceHandle) -> int:
        """Tokens this sequence may still generate: what its KV allocation
        must cover beyond the prompt. A preempted replay's prompt already
        holds its generated tokens."""
        return max(1, handle.sampling.max_new_tokens - handle.generated)

    def _admission_pages(self, handle: SequenceHandle) -> int:
        """KV pages an admission must cover for this handle, shared head
        included: prompt plus what it may still generate (no mid-flight
        allocation)."""
        return pages_needed(len(handle.prompt_ids) + self._remaining_new(handle),
                            self.engine.page_size)

    def _shed_expired(self) -> None:
        """Pending requests past their deadline are dropped before admission
        with a structured retryable error: admitting them would spend
        prefill on an answer the caller has given up on. Live streams are
        never shed: a preempted handle owes its client the rest."""
        if not self.pending:
            return
        now = time.perf_counter()
        for handle in list(self.pending):
            if (handle.deadline is not None and now > handle.deadline
                    and handle.generated == 0 and not handle.preempted):
                self.pending.remove(handle)
                self.metrics.inc("finchat_sheds_total")
                TRACER.anomaly("shed", handle.trace_id, args={"seq_id": handle.seq_id})
                handle.finished = True
                handle.span.finish()
                handle.events.put_nowait({
                    "type": "error",
                    "message": "deadline exceeded before admission; retry with backoff",
                    "code": "deadline_exceeded",
                    "retryable": True,
                })
        self.metrics.set_gauge("finchat_queue_depth", len(self.pending))

    def _prepare_pending(self) -> None:
        """Shed expired entries, then order the queue for admission:
        earliest deadline first (entries without one last, FIFO among
        themselves), with a starvation guard: an entry that has waited
        longer than ``edf_starvation_seconds`` goes ahead of deadline order
        (in queue order among the starved). A queue with no deadline is left
        as it is."""
        self._shed_expired()
        if len(self.pending) <= 1 or all(h.deadline is None for h in self.pending):
            return
        now = time.perf_counter()

        def key(h: SequenceHandle):
            if now - h.submitted_at > self.edf_starvation_s:
                return (0, 0.0)  # starved: ahead of EDF, in queue order (stable sort)
            return (1, h.deadline if h.deadline is not None else float("inf"))

        self.pending = deque(sorted(self.pending, key=key))

    def _admit(self) -> None:
        self._prepare_pending()
        admitted: dict[int, list[int]] = {}
        ctx_rows: dict[int, int] = {}
        page = self.engine.page_size
        while self.pending and self.free_slots:
            handle = self.pending[0]
            total = self._admission_pages(handle)
            if total > self.engine.max_pages_per_seq:
                break  # head-of-line waits (refused at submit anyway)
            entry, shared_len = self._match_prefix(handle.prompt_ids)
            # session tier: a per-conversation resume takes over whenever it
            # matches deeper than the shared head (it holds the head as its
            # own leading pages)
            s_entry, s_matched = None, 0
            session_eligible = self.session_cache is not None and bool(handle.conversation_id)
            if session_eligible:
                if self.session_cache.get(handle.conversation_id) is None:
                    # a RAM miss falls through to the disk tier; match()
                    # below then compares tokens and truncates as usual
                    self._restore_session_from_disk(handle.conversation_id)
                s_entry, s_matched = self.session_cache.match(handle.conversation_id,
                                                              handle.prompt_ids)
                if s_entry is None or s_matched <= shared_len:
                    s_entry, s_matched = None, 0
            if s_entry is not None:
                # head pages referenced (never copied); the pages past the
                # head restore from the host snapshot below
                head_pages = s_entry.prefix_pages[: min(s_matched, s_entry.prefix_len) // page]
                n_restore = s_entry.own_pages_for(s_matched, page)
                ref_entry = s_entry.prefix_entry if head_pages else None
                resume_pos = s_matched
            else:
                head_pages = entry.pages[: shared_len // page] if entry else []
                n_restore = 0
                ref_entry = entry
                resume_pos = shared_len
            need = total - len(head_pages)
            if not self.allocator.can_allocate(need):
                break  # head-of-line waits for pages
            self.pending.popleft()
            slot = self.free_slots.pop()
            pages = self.allocator.allocate(handle.seq_id, need)
            if n_restore:
                try:
                    inject("session.restore", seq_id=handle.seq_id)
                    with Timer(self.metrics, "finchat_session_restore_seconds"):
                        self.engine.restore_pages(pages[:n_restore], s_entry.snap)
                    self.metrics.inc("finchat_session_cache_restored_tokens_total", resume_pos)
                except Exception as e:
                    # a failed restore must neither kill the stream nor leak
                    # its pages: return them and start cold on the plain
                    # shared-prefix plan
                    logger.error("session cache restore failed for %s: %s", handle.seq_id, e)
                    self.allocator.free(handle.seq_id, pages)
                    s_entry = None
                    head_pages = entry.pages[: shared_len // page] if entry else []
                    ref_entry = entry
                    resume_pos = shared_len
                    need = total - len(head_pages)
                    if not self.allocator.can_allocate(need):
                        # the cold plan needs more pages than the resume
                        self.pending.appendleft(handle)
                        self.free_slots.append(slot)
                        break
                    pages = self.allocator.allocate(handle.seq_id, need)
            if session_eligible:
                # counted only for an admission that went through its plan
                self.metrics.inc("finchat_session_cache_hits_total" if s_entry is not None
                                 else "finchat_session_cache_misses_total")
            # head pages lead (logical pages 0..): the slot reads them
            # read-only, its own writes all land at positions >= resume_pos
            admitted[slot] = head_pages + pages
            handle.page_list = admitted[slot]
            handle.shared_len = len(head_pages) * page
            handle.resumed_len = resume_pos if s_entry is not None else 0
            if ref_entry is not None:
                ref_entry.refs += 1
                handle.prefix_entry = ref_entry
            if resume_pos:
                ctx_rows[slot] = resume_pos
                handle.prefill_pos = resume_pos
                if s_entry is None:
                    self.metrics.inc("finchat_prefix_hits_total")
                    self.metrics.inc("finchat_prefix_tokens_saved_total", shared_len)
            handle.slot = slot
            handle.span.mark("admitted")
            if handle.constraint is None:
                self._temperature[slot] = handle.sampling.temperature
                self._top_p[slot] = handle.sampling.top_p
                self._top_k[slot] = handle.sampling.top_k
            # a constrained slot keeps the non-truncating defaults: its
            # device-sampled token is always replaced by the host pick, and a
            # truncating top_p/top_k would take the whole batch off the
            # sampler's exact full-vocab path
            self.prefilling.append(handle)
            logger.debug("admitted %s into slot %d (%d pages)", handle.seq_id, slot, need)
        if admitted:
            # ONE device update for the whole admission burst
            self.engine.set_page_table_rows(admitted)
            if ctx_rows:
                self.engine.set_context_lens_rows(ctx_rows)
            self.metrics.set_gauge("finchat_queue_depth", len(self.pending))

    def _finish(self, handle: SequenceHandle, reason: str) -> None:
        handle.finished = True
        handle.span.finish()
        handle.events.put_nowait({"type": "done", "reason": reason})

    def _release(self, handle: SequenceHandle) -> None:
        if handle.slot < 0:
            return
        pages = self.allocator.owned_by(handle.seq_id)
        if pages:
            self.allocator.free(handle.seq_id, pages)
        try:
            self.engine.reset_slot(handle.slot)
        except Exception as e:
            # admission rewrites the page-table row and context length
            # anyway; the slot must still return to the free list
            logger.error("slot reset failed releasing %s: %s", handle.seq_id, e)
        self.decoding.pop(handle.slot, None)
        if handle in self.prefilling:
            self.prefilling.remove(handle)
        # non-truncating defaults keep the sampler on its exact fast path
        self._temperature[handle.slot] = 0.0
        self._top_p[handle.slot] = 1.0
        self._top_k[handle.slot] = 0
        self.free_slots.append(handle.slot)
        handle.slot = -1
        if handle.prefix_entry is not None:
            handle.prefix_entry.refs -= 1
            handle.prefix_entry = None
            self._reap_prefixes()

    def _session_drop(self, entry: SessionEntry) -> None:
        """The session cache's ``on_drop`` hook (eviction, replacement or
        truncation to nothing): release the entry's reference on its shared
        head, so retirement can free those pages."""
        if entry.prefix_entry is not None:
            entry.prefix_entry.refs -= 1
            entry.prefix_entry = None
            self._reap_prefixes()

    def _maybe_offload(self, handle: SequenceHandle) -> None:
        """Snapshot a normally retiring sequence's KV into the session cache
        BEFORE its pages are freed. Whole pages only (the matcher is
        page-granular). The copy blocks (``engine.offload_pages``) by design:
        the pages return to the allocator the moment this returns, and the
        next decode step may already be enqueued."""
        cache = self.session_cache
        if cache is None or not handle.conversation_id or handle.slot < 0:
            return
        if handle.prefill_pos < len(handle.prompt_ids) or not handle.generated:
            return  # never reached decode; nothing coherent to keep
        page = self.engine.page_size
        # KV-cached tokens: prompt + generated minus the last delivered
        # token, whose append belongs to a step that was never consumed
        context = len(handle.history) - 1
        n_tok = (context // page) * page
        if n_tok <= 0:
            return
        shared = min(handle.shared_len, n_tok)
        # incremental offload: the pages of [shared, resumed_len) were
        # restored from the previous entry and never rewritten (the slot's
        # writes start at resumed_len), so reuse those host bytes
        prev = cache.get(handle.conversation_id)
        reuse_pages = 0
        if (prev is not None and prev.snap is not None
                and prev.prefix_len == shared and handle.resumed_len > shared):
            m = min(handle.resumed_len, n_tok, prev.n_tokens)
            reuse_pages = (m - shared) // page
            if reuse_pages and not np.array_equal(
                    prev.token_ids[shared : shared + reuse_pages * page],
                    np.asarray(handle.history[shared : shared + reuse_pages * page], np.int32)):
                reuse_pages = 0  # the entry was replaced by another stream since
        own_ids = handle.page_list[shared // page + reuse_pages : n_tok // page]
        try:
            inject("session.offload", seq_id=handle.seq_id)
            with Timer(self.metrics, "finchat_session_offload_seconds"):
                snap_new = self.engine.offload_pages(own_ids) if own_ids else None
        except Exception as e:  # the cache is an optimization; never fail eviction
            logger.error("session cache offload failed for %s: %s", handle.seq_id, e)
            return
        entry = SessionEntry(
            conversation_id=handle.conversation_id,
            token_ids=np.asarray(handle.history[:n_tok], np.int32),
            prefix_entry=handle.prefix_entry if shared else None,
            prefix_pages=list(handle.page_list[: shared // page]),
            prefix_len=shared,
            snap=concat_snaps(prev.snap if reuse_pages else None, reuse_pages, snap_new),
        )
        # reference the head BEFORE put(): put may drop an older entry
        # holding the same head, and a momentary refs == 0 would free pages
        # the new entry is about to point at
        if entry.prefix_entry is not None:
            entry.prefix_entry.refs += 1
        if cache.put(entry):
            self.metrics.inc("finchat_session_cache_offloaded_pages_total", len(own_ids))
        elif entry.prefix_entry is not None:
            entry.prefix_entry.refs -= 1
            self._reap_prefixes()

    def _evict(self, handle: SequenceHandle, reason: str, error: str | None = None) -> None:
        if error is None and reason in ("eos", "length"):
            # normal retirement: the KV is a coherent prefix of this
            # conversation's next turn; offload before the pages free
            self._maybe_offload(handle)
        self._release(handle)
        if error is not None:
            handle.finished = True
            handle.span.finish()
            handle.events.put_nowait({"type": "error", "message": error})
        else:
            self._finish(handle, reason)

    # --- recompute preemption ---------------------------------------------
    def _preempt(self, handle: SequenceHandle, *, for_rebuild: bool = False) -> None:
        """Free the victim's slot and KV pages but keep its prompt and
        generated tokens on the handle: the replay sets ``prompt_ids`` to
        the history, so re-admission re-prefills exactly the stream so far
        (through the shared-prefix and session caches, which usually makes
        it cheap) and its first commit samples exactly the next token. A
        token of the victim still riding a dispatch is dropped at consume
        time (the epoch moved) and recomputed by the replay.

        Used for page pressure and as the breaker's recovery primitive;
        ``for_rebuild`` skips the per-slot device reset (the whole device
        state is about to be replaced, and the engine may be wedged)."""
        if handle.finished:
            return
        slot = handle.slot
        if slot >= 0:
            pages = self.allocator.owned_by(handle.seq_id)
            if pages:
                self.allocator.free(handle.seq_id, pages)
            self.decoding.pop(slot, None)
            if handle in self.prefilling:
                self.prefilling.remove(handle)
            self._temperature[slot] = 0.0
            self._top_p[slot] = 1.0
            self._top_k[slot] = 0
            self.free_slots.append(slot)
            handle.slot = -1
            if handle.prefix_entry is not None:
                handle.prefix_entry.refs -= 1
                handle.prefix_entry = None
                if not for_rebuild:
                    self._reap_prefixes()
            if not for_rebuild:
                try:
                    self.engine.reset_slot(slot)
                except Exception as e:
                    # admission rewrites the row and context length anyway;
                    # a wedged device trips the breaker
                    logger.error("slot reset failed preempting %s: %s", handle.seq_id, e)
        elif handle in self.pending:
            return  # already queued
        handle.prompt_ids = list(handle.history)
        handle.prefill_pos = 0
        handle.page_list = []
        handle.shared_len = 0
        handle.resumed_len = 0
        handle.grafted = False
        handle.preempted += 1
        handle.epoch += 1  # stale dispatch memberships no longer match
        # live streams re-admit ahead of new load (EDF ordering applies on
        # top when deadlines are in play); a held prefix re-prefills and
        # parks again
        self.pending.appendleft(handle)
        self.metrics.inc("finchat_preemptions_total")
        if TRACER.enabled and handle.trace_id is not None:
            TRACER.event("preempt", handle.trace_id, track=self._trace_track,
                         args={"preempted": handle.preempted, "for_rebuild": for_rebuild})
        self.metrics.set_gauge("finchat_queue_depth", len(self.pending))
        self._wakeup.set()

    def _preemption_plan(self) -> list[SequenceHandle]:
        """Page pressure: when the earliest-deadline pending request cannot
        be admitted for lack of KV pages, the latest-deadline decoding
        victims (no deadline = lowest priority) whose deadlines are strictly
        later than the candidate's and whose pages make the admission fit.
        Strict order keeps it livelock-free: a victim can never preempt the
        sequence it yielded to. [] when preemption is off, nothing is
        stalled, no victim qualifies, or all of them would not free enough
        (preempting without admitting is pure loss). Planning only: the
        loop drains the step in flight before it preempts, so no freed page
        is still the target of a queued write."""
        if not self.preemption_enabled or not self.pending or not self.decoding:
            return []
        self._prepare_pending()
        if not self.pending:
            return []
        cand = self.pending[0]
        if cand.deadline is None:
            return []  # only deadline urgency justifies evicting live KV
        page = self.engine.page_size
        total = self._admission_pages(cand)
        if total > self.engine.max_pages_per_seq:
            return []
        # the plan _admit will make: a head the candidate shares needs no pages
        _, shared_len = self._match_prefix(cand.prompt_ids)
        need = total - shared_len // page
        if self.free_slots and self.allocator.can_allocate(need):
            return []  # admissible as it is

        def eff(h: SequenceHandle) -> float:
            return h.deadline if h.deadline is not None else float("inf")

        pool = [h for h in self.decoding.values() if not h.finished and eff(h) > cand.deadline]
        pool.sort(key=eff, reverse=True)
        victims: list[SequenceHandle] = []
        freeable = self.allocator.free_count
        for v in pool:
            victims.append(v)
            freeable += len(self.allocator.owned_by(v.seq_id))
            if freeable >= need:
                return victims
        return []

    def adopt(self, handle: SequenceHandle) -> bool:
        """Admit a handle another scheduler gave up. It arrives device-free
        (``_preempt`` normalized it) with its ``events`` queue, so its
        consumer keeps streaming. A live stream (preempted or with tokens)
        goes to the queue's head and is always taken; a never-admitted one
        is plain load and honours ``max_queue_depth`` (False = refused).
        Returns whether the handle was taken."""
        if handle.finished:
            return True
        live = bool(handle.preempted or handle.generated)
        if (not live and self.max_queue_depth > 0
                and len(self.pending) >= self.max_queue_depth):
            return False
        handle.owner = self  # cancel() must reach this scheduler now
        if TRACER.enabled and handle.trace_id is not None:
            TRACER.event("adopt", handle.trace_id, track=self._trace_track,
                         args={"live": live})
        if live:
            self.pending.appendleft(handle)
        else:
            self.pending.append(handle)
        self.metrics.set_gauge("finchat_queue_depth", len(self.pending))
        self._wakeup.set()
        return True

    async def shutdown_drain(self) -> None:
        """Graceful shutdown: stop the loop, then end every straggler with
        a structured retryable ``shutting_down`` error, its coherent KV
        offloaded into the session tier (which writes through to disk)
        before its slot and pages are released. Pending work fails the same
        way. A held prefix is no conversation state: it is released and
        failed without an offload. Afterwards only the shared heads' pages
        are still owned."""
        await self.stop()
        shutdown_error = {
            "type": "error",
            "message": "server shutting down; retry with backoff",
            "code": "shutting_down", "retryable": True,
        }
        for handle in list(self.decoding.values()) + list(self.prefilling):
            if not handle.held:
                try:
                    # a mid-decode straggler's prompt and generated KV are
                    # the snapshot a normal retirement takes
                    self._maybe_offload(handle)
                except Exception as e:
                    logger.error("shutdown offload failed for %s: %s", handle.seq_id, e)
            self._release(handle)
            handle.finished = True
            handle.span.finish()
            handle.events.put_nowait(dict(shutdown_error))
        for handle in list(self.pending):
            self.pending.remove(handle)
            handle.finished = True
            handle.span.finish()
            handle.events.put_nowait(dict(shutdown_error))
        self.metrics.set_gauge("finchat_queue_depth", 0)
        self.spill_sessions()

    # --- the circuit breaker ------------------------------------------------
    async def revive_async(self) -> bool:
        """Rebuild a given-up scheduler's device state from a clean slate so
        it serves again. Only callable with nothing live here. The device
        rebuild runs in a worker thread (a pool's reallocation is seconds at
        real sizes); the host bookkeeping stays on the loop. Returns True
        when the engine is serving again."""
        self._revive_prepare()
        if not await asyncio.to_thread(self._revive_rebuild):
            return False
        self._revive_commit()
        return True

    def _revive_prepare(self) -> None:
        """Clean-slate host bookkeeping ahead of the rebuild (idempotent)."""
        if self.decoding or self.prefilling:
            raise RuntimeError("revive_async() with live sequences; drain first")
        self._reset_for_rebuild()

    def _reset_for_rebuild(self) -> None:
        """What a rebuild of the device state invalidates on the host, reset
        before the rebuild: the old pool goes either way, and a failed
        rebuild must not strand pages or slots. Prefix jobs resolve to 0
        with no device op (the engine may be wedged); caches that refer to
        device pages are dropped: session entries riding a head first
        (their on_drop releases the head references), then the heads."""
        for job in list(self._prefix_jobs):
            self._prefix_jobs.remove(job)
            if not job.future.done():
                job.future.set_result(0)
        if self.session_cache is not None:
            self.session_cache.discard_if(
                lambda e: e.prefix_len > 0 or e.prefix_entry is not None)
        self._prefixes.clear()
        self.allocator.reset()
        self.free_slots = list(range(self.engine.engine_cfg.max_seqs))
        self._temperature[:] = 0.0
        self._top_p[:] = 1.0
        self._top_k[:] = 0

    def _revive_rebuild(self) -> bool:
        """The device-only half (touches the engine, not the scheduler, so
        it runs in a thread)."""
        try:
            inject("engine.rebuild")
            with Timer(self.metrics, "finchat_engine_rebuild_seconds"):
                self.engine.rebuild_device_state()
        except Exception as e:
            logger.error("revive: engine rebuild failed: %s", e)
            return False
        return True

    def _revive_commit(self) -> None:
        self.gave_up = False
        self._rebuilds_without_success = 0
        for bucket in self._fail_streaks:
            self._fail_streaks[bucket] = 0
        self._breaker_bucket = None
        self._breaker_tripped_at = None
        self.metrics.set_gauge("finchat_breaker_state", 0)
        self.metrics.inc("finchat_engine_rebuilds_total")
        for cb in list(self.on_rebuild):
            try:
                cb()
            except Exception as e:
                logger.error("on_rebuild callback failed: %s", e)
        self._wakeup.set()

    async def _round_failed(self, scope: str, error: str) -> None:
        """A whole-round dispatch failure, not attributable to one sequence.
        Breaker off (``breaker_threshold`` 0): the round's population is
        evicted with an error. Breaker on: the plane's failure streak
        ("prefill", or "decode" for decode and mixed rounds) advances; below
        the threshold the round's sequences are preempted and replay, at the
        threshold the breaker trips (``_trip_breaker``). A failed dispatch
        is never consumed again: a partly consumed step cannot be told from
        an unconsumed one, and the replay recomputes what was not
        delivered."""
        self.metrics.inc("finchat_dispatch_failures_total")
        if self.breaker_threshold <= 0:
            if scope in ("prefill", "mixed"):
                self._fail_prefill_round(error)
            if scope in ("decode", "mixed"):
                for handle in list(self.decoding.values()):
                    self._evict(handle, "error", error=error)
            return
        bucket = "prefill" if scope == "prefill" else "decode"
        self._fail_streaks[bucket] += 1
        if self._fail_streaks[bucket] >= self.breaker_threshold:
            await self._trip_breaker(bucket, error)
            return
        if scope in ("prefill", "mixed"):
            for handle in list(self.prefilling):
                if not self._parked(handle):  # a parked hold was in no round
                    self._preempt(handle)
            for job in list(self._prefix_jobs):
                try:  # registration is best-effort
                    self._fail_prefix_job(job)
                except Exception as e:
                    logger.error("failing prefix job during %s failure: %s", scope, e)
        if scope in ("decode", "mixed"):
            for handle in list(self.decoding.values()):
                self._preempt(handle)

    def _note_round_ok(self, bucket: str) -> None:
        """A round of ``bucket`` completed: its failure streak resets, and
        if this plane tripped the breaker, the half-open breaker closes (the
        recovery time observed from the trip) and the consecutive-rebuild
        count clears."""
        self._fail_streaks[bucket] = 0
        if self._breaker_bucket in (None, bucket):
            self._rebuilds_without_success = 0
            self._breaker_bucket = None
            if self._breaker_tripped_at is not None:
                self.metrics.observe("finchat_breaker_recovery_seconds",
                                     time.perf_counter() - self._breaker_tripped_at)
                self._breaker_tripped_at = None
                self.metrics.set_gauge("finchat_breaker_state", 0)

    async def _trip_breaker(self, bucket: str, error: str) -> None:
        """Preempt every live sequence to the host, drop every cache entry
        that refers to device pages (shared heads, session entries riding
        one), reset the allocator and slots, and rebuild the engine's device
        state with the weights kept. The next iteration is the half-open
        probe: admission replays the preempted streams, and the first
        successful round of the plane closes the breaker.
        ``breaker_max_rebuilds`` trips without a successful round in between
        give up instead: the live streams fail with the error, and the
        scheduler keeps serving new admissions.

        The rebuild runs in a worker thread, so the event loop keeps
        serving; all host bookkeeping is done before the await, and
        ``_rebuilding`` gates register_prefix_async meanwhile."""
        self._breaker_bucket = bucket
        self._rebuilds_without_success += 1
        if self._rebuilds_without_success > self.breaker_max_rebuilds:
            # the black box of the give-up: the tripped rounds' dispatches
            # and the failing streams' lifecycle at the moment it gives up
            TRACER.anomaly("replica_give_up", args={
                "plane": bucket, "error": str(error)[:200],
                "rebuilds": self._rebuilds_without_success - 1,
            })
            logger.error("breaker: %d consecutive rebuilds without a successful round; "
                         "failing in-flight streams (%s)",
                         self._rebuilds_without_success - 1, error)
            for handle in list(self.decoding.values()) + list(self.prefilling):
                try:
                    self._evict(handle, "error", error=error)
                except Exception as e:
                    logger.error("evicting %s after breaker give-up: %s", handle.seq_id, e)
            for job in list(self._prefix_jobs):
                try:  # the slot and pages come back even on a give-up
                    self._fail_prefix_job(job)
                except Exception as e:
                    logger.error("failing prefix job at breaker give-up: %s", e)
            for b in self._fail_streaks:
                self._fail_streaks[b] = 0
            # degraded but serving: the gauge closes and the trip time goes,
            # so a later recovery does not count the idle period; the rebuild
            # count stays, so another trip without a success gives up at once
            self._breaker_tripped_at = None
            self.metrics.set_gauge("finchat_breaker_state", 0)
            self.gave_up = True
            for cb in list(self.on_give_up):
                try:
                    cb()
                except Exception as e:
                    logger.error("on_give_up callback failed: %s", e)
            return
        logger.error("breaker tripped (%s): preempting %d live sequences and rebuilding the "
                     "engine's device state", error, len(self.decoding) + len(self.prefilling))
        # the flight recorder: the trip and the ring up to it (the tripped
        # rounds' dispatches, every live stream's lifecycle); the dump
        # writes in a worker thread
        TRACER.anomaly("breaker_trip", args={
            "plane": bucket, "error": str(error)[:200],
            "dispatch_tally": self._dispatch_tally,
            "live": len(self.decoding) + len(self.prefilling),
        })
        if self._breaker_tripped_at is None:
            self._breaker_tripped_at = time.perf_counter()
        self.metrics.set_gauge("finchat_breaker_state", 1)
        for handle in list(self.decoding.values()):
            self._preempt(handle, for_rebuild=True)
        for handle in list(self.prefilling):
            # parked holds too: their prefix KV goes with the pool, so they
            # re-prefill and park again
            self._preempt(handle, for_rebuild=True)
        self._reset_for_rebuild()
        try:
            self._rebuilding = True
            try:
                with Timer(self.metrics, "finchat_engine_rebuild_seconds"):
                    await asyncio.to_thread(self.engine.rebuild_device_state)
            finally:
                self._rebuilding = False
        except Exception as e:
            # the rebuild failed (device gone?): fail the preempted streams
            # and leave the breaker open; the next trip retries the rebuild
            logger.error("engine rebuild failed: %s", e)
            for handle in list(self.pending):
                if handle.preempted:
                    self.pending.remove(handle)
                    handle.finished = True
                    handle.span.finish()
                    handle.events.put_nowait(
                        {"type": "error", "message": f"engine rebuild failed: {e}"})
            return
        for b in self._fail_streaks:
            self._fail_streaks[b] = 0
        self.metrics.inc("finchat_engine_rebuilds_total")
        self.metrics.set_gauge("finchat_breaker_state", 2)  # half-open
        for cb in list(self.on_rebuild):
            try:
                cb()
            except Exception as e:
                logger.error("on_rebuild callback failed: %s", e)

    # --- session transfer -------------------------------------------------
    def export_session(self, conversation_id: str | None) -> dict | None:
        """Device-independent image of a conversation's session entry
        (SessionKVCache.export_entry)."""
        if self.session_cache is None or not conversation_id:
            return None
        return self.session_cache.export_entry(conversation_id)

    def import_session_entry(self, payload: dict | None, *, spill: bool = True) -> bool:
        """Adopt an exported session entry (or a disk record). An entry
        whose KV rode a shared head re-links against THIS scheduler's live
        registration of the same head, refcounted like a local offload; no
        matching live head, a bounded-KV record (``kv_gap``: the JAX
        package's windowed plane, not served here), or a snapshot of the
        other page-pool dtype refuses it (counted) and the conversation
        resumes cold."""
        if payload is None or self.session_cache is None:
            return False
        if payload.get("kv_gap"):
            logger.warning("session import for %s refused: a bounded-KV entry (kv_gap %d) — "
                           "cold start", payload.get("conversation_id"), payload["kv_gap"])
            self.metrics.inc("finchat_fleet_session_import_refused_total")
            return False
        if (payload.get("snap") is not None
                and snap_kv_mode(payload["snap"]) != self.engine.kv_quant):
            logger.warning("session import for %s refused: snapshot kv mode %r vs engine "
                           "kv_quant %r — cold start", payload.get("conversation_id"),
                           snap_kv_mode(payload["snap"]), self.engine.kv_quant)
            self.metrics.inc("finchat_quant_dequant_fallbacks_total")
            return False
        prefix_len = int(payload["prefix_len"])
        entry_ref = None
        pages: list[int] = []
        if prefix_len > 0:
            page = self.engine.page_size
            head_ids = [int(t) for t in payload["token_ids"][:prefix_len]]
            if prefix_len % page == 0:
                for cand in self._prefixes:
                    if (not cand.retired and cand.shared_len >= prefix_len
                            and cand.ids[:prefix_len] == head_ids):
                        entry_ref = cand
                        pages = cand.pages[: prefix_len // page]
                        break
            if entry_ref is None:
                self.metrics.inc("finchat_fleet_session_import_refused_total")
                return False
            # reference BEFORE put (the _maybe_offload discipline)
            entry_ref.refs += 1
        ok = self.session_cache.import_entry(payload, prefix_entry=entry_ref,
                                             prefix_pages=pages, spill=spill)
        if not ok and entry_ref is not None:
            entry_ref.refs -= 1
            self._reap_prefixes()
        return ok

    def _restore_session_from_disk(self, conversation_id: str) -> bool:
        """RAM-miss fall-through to the disk tier: load the conversation's
        record (checksummed; a corrupt one is quarantined) and adopt it
        through ``import_session_entry``. Returns True when the entry is
        now resident in RAM."""
        cache = self.session_cache
        if cache is None or cache.disk is None or conversation_id not in cache.disk:
            return False
        with Timer(self.metrics, "finchat_durability_restore_seconds"):
            payload = cache.disk.load(conversation_id)
            if payload is None:
                return False  # quarantined or set aside: cold start
            # an over-budget record is trimmed to the prefix that fits; one
            # that cannot fit at all is dropped (put would refuse it every turn)
            payload = cache.fit_payload(payload)
            if payload is None:
                cache.disk.discard(conversation_id)
                return False
            try:
                # spill=False: these bytes just came off this disk tier
                ok = self.import_session_entry(payload, spill=False)
            except Exception as e:
                logger.error("disk session restore failed for %s: %s", conversation_id, e)
                return False
        if ok:
            self.metrics.inc("finchat_durability_disk_restores_total")
        return ok

    def spill_sessions(self) -> int:
        """Write every resident session entry through to the disk tier and
        wait for the writes (graceful shutdown)."""
        if self.session_cache is None:
            return 0
        return self.session_cache.spill_all()

    def _tally_dispatch(self) -> None:
        self._dispatch_tally += 1

    def _trace_dispatch(self, kind: str, rows: list, *, ts: float | None = None,
                        dur: float | None = None) -> None:
        """Record one model dispatch in the trace ring: which ``[slot,
        trace_id, mode]`` rows rode it, so a request's exported timeline
        shows every dispatch that carried it even when many requests share
        one ragged dispatch. Host data only, no device sync; callers build
        the rows only under ``TRACER.enabled``."""
        TRACER.event("dispatch", ts=ts, dur=dur, track=self._trace_track,
                     args={"kind": kind, "n": self._dispatch_tally,
                           "quant": self.quant_label, "rows": rows})

    @staticmethod
    def _parked(handle: SequenceHandle) -> bool:
        """A parked hold: its prefix is prefilled and it waits for
        extend_prompt. It is no prefill work and rides no round: the one
        predicate the round builders, the round-failure handlers and the
        idle check share."""
        return handle.held and handle.prefill_pos >= len(handle.prompt_ids)

    def _reap_stale_holds(self) -> None:
        """Holds past ``held_deadline`` lost their owner: free them."""
        now = time.perf_counter()
        for handle in list(self.prefilling):
            if handle.held and now > handle.held_deadline:
                logger.warning("partial hold %s expired after %.0fs without extend_prompt; "
                               "reclaiming its slot and pages", handle.seq_id, self.hold_ttl_s)
                self.metrics.inc("finchat_partial_stale_reaps_total")
                self._evict(handle, "error", error="partial hold expired")
        for handle in list(self.pending):
            if handle.held and now > handle.held_deadline:
                self.metrics.inc("finchat_partial_stale_reaps_total")
                self.pending.remove(handle)
                handle.finished = True
                handle.span.finish()
                handle.events.put_nowait({"type": "error", "message": "partial hold expired"})

    def _constrained_pick(self, handle: SequenceHandle, row_logits: np.ndarray) -> int:
        """The host-side grammar pick of one constrained slot: choose the
        token from its logits row, write it back as the slot's next decode
        input, and return it for delivery. The write lands in the engine's
        current ``last_tokens``, the tensor the slot's next dispatch reads:
        a slot whose pick is pending sits out the step dispatched before
        it, so that step only carries its old value forward."""
        s = handle.sampling
        token = handle.constraint.pick(row_logits, s.temperature, self._rng,
                                       remaining=s.max_new_tokens - handle.generated,
                                       top_p=s.top_p, top_k=s.top_k)
        self.engine.set_last_token(handle.slot, token)
        return token

    async def _prefill_round(self) -> None:
        """Advance every prefilling sequence one chunk in a single batched
        ``prefill_step``, the batch padded to a power of two; completed
        prompts sample their first token (``commit_first_token``), a
        constrained one on the host from its logits row, and a completed
        hold parks. Chunked prefix registrations ride the same step as rows
        that sample nothing."""
        eng = self.engine
        C = eng.engine_cfg.prefill_chunk
        batch = self._prefill_batch()
        jobs = list(self._prefix_jobs)
        if not batch and not jobs:
            return
        rows = [(h.slot, h.prompt_ids, h.prefill_pos) for h in batch]
        rows += [(j.slot, j.ids, j.pos) for j in jobs]
        N = round_up_pow2(len(rows))
        tokens, slots, starts, n_valids = self._pack_prefill_rows(rows, N, C)
        with Timer(self.metrics, "finchat_prefill_seconds") as pt:
            logits = eng.prefill_chunk(tokens, slots, starts, n_valids)
        self._tally_dispatch()
        if TRACER.enabled:
            trows = [[h.slot, h.trace_id or h.seq_id, "prefill"] for h in batch]
            trows += [[j.slot, f"prefix:{j.owner}", "prefix"] for j in jobs]
            self._trace_dispatch("prefill", trows, ts=pt.started, dur=pt.elapsed)
        # (handle, batch row, epoch): the epoch tells a preempted and
        # replayed incarnation from the one this round prefilled
        completions: list[tuple[SequenceHandle, int, int]] = []
        for i, handle in enumerate(batch):
            handle.prefill_pos += int(n_valids[i])
            if handle.prefill_pos >= len(handle.prompt_ids):
                if handle.held:
                    continue  # park: the first token waits for the graft
                completions.append((handle, i, handle.epoch))
        for i, job in enumerate(jobs, start=len(batch)):
            job.pos += int(n_valids[i])
            if job.pos >= job.shared_len:
                self._complete_prefix_job(job, "chunked")
        if not completions:
            return  # dispatch-only round, no host sync needed
        tokens_dev = []
        for h, i, _epoch in completions:
            h.span.mark("prefill_done")
            s = h.sampling
            tokens_dev.append(eng.commit_first_token(h.slot, logits[i], s.temperature,
                                                     s.top_p, s.top_k))
        # only the constrained completions' logits rows leave the card
        picks = [i for h, i, _epoch in completions if h.constraint is not None]
        picked = eng.select_rows(logits, picks) if picks else None
        # one host fetch for all completions (worker thread keeps the loop live)
        fetched, logits_host = await asyncio.to_thread(
            lambda: ([int(eng.to_host(t)) for t in tokens_dev],
                     eng.to_host(picked) if picked is not None else None))
        for (handle, i, epoch), token_id in zip(completions, fetched):
            if handle.finished or handle.epoch != epoch:
                continue  # cancelled or preempted while fetching
            try:
                if handle.constraint is not None:
                    token_id = self._constrained_pick(handle, logits_host[picks.index(i)])
                self.prefilling.remove(handle)
                self.decoding[handle.slot] = handle
                self._deliver(handle, int(token_id))
            except Exception as e:  # a pick or delivery error fails its sequence only
                logger.error("prefill completion error for %s: %s", handle.seq_id, e)
                self._evict(handle, "error", error=str(e))

    def _prefill_batch(self) -> list[SequenceHandle]:
        """The prefilling sequences that go into this round (parked holds
        stay out): each passes its ``scheduler.prefill`` fault site, and
        one that fails there is evicted with an error on its own while the
        others go on."""
        batch = []
        for handle in list(self.prefilling):
            if self._parked(handle):
                continue  # awaiting extend_prompt
            try:
                inject("scheduler.prefill", seq_id=handle.seq_id)
            except Exception as e:  # per-sequence isolation
                logger.error("prefill error for %s: %s", handle.seq_id, e)
                self._evict(handle, "error", error=str(e))
                continue
            batch.append(handle)
        return batch

    @staticmethod
    def _pack_prefill_rows(rows, N: int, C: int):
        """Row arrays for a chunked prefill round: one chunk per
        ``(slot, ids, pos)`` row; padding rows carry the first row's slot
        with ``n_valid 0`` (trash writes)."""
        tokens = np.zeros((N, C), np.int32)
        slots = np.zeros((N,), np.int32)
        starts = np.zeros((N,), np.int32)
        n_valids = np.zeros((N,), np.int32)
        slots[:] = rows[0][0]
        for i, (slot, ids, pos) in enumerate(rows):
            chunk = ids[pos : pos + C]
            tokens[i, : len(chunk)] = chunk
            slots[i] = slot
            starts[i] = pos
            n_valids[i] = len(chunk)
        return tokens, slots, starts, n_valids

    def _fail_prefill_round(self, error: str) -> None:
        """A whole prefill round failed: fail what was in it. A parked hold
        was not (it waits for extend_prompt) and survives."""
        for handle in list(self.prefilling):
            if self._parked(handle):
                continue
            self._evict(handle, "error", error=error)
        for job in list(self._prefix_jobs):
            self._fail_prefix_job(job)

    def _prefill_work(self) -> bool:
        """Is there prefill work: a prefilling sequence that is not a parked
        hold, or a registration? Parked holds are none, so an otherwise idle
        loop sleeps instead of spinning through the retrieval."""
        return any(not self._parked(h) for h in self.prefilling) or bool(self._prefix_jobs)

    def _use_mixed(self) -> bool:
        """One packed ragged dispatch instead of a prefill round plus a
        decode step: both populations must exist."""
        return self.mixed_enabled and bool(self.decoding) and self._prefill_work()

    async def _ragged_round(self) -> None:
        """Advance every prefilling sequence a chunk and every decoding slot
        a token in ONE packed ragged dispatch, with one host fetch. Prefill
        rows whose prompt completes sample their first token on the device
        in the same dispatch (a completed hold parks instead); constrained
        completions and decode rows bring their logits rows back for the
        host pick, at the non-truncating sampling defaults. Chunked prefix
        registrations ride it as rows that sample nothing."""
        eng = self.engine
        C = eng.engine_cfg.prefill_chunk
        R = B = eng.engine_cfg.max_seqs
        batch = self._prefill_batch()
        jobs = list(self._prefix_jobs)
        decode_members = [(slot, h, h.epoch) for slot, h in self.decoding.items()]
        if (not batch and not jobs) or not decode_members:
            return  # a fault above drained one side; the split path goes on
        inject("scheduler.decode")
        # the ragged round's own site: fails this dispatch alone while the
        # split path stays healthy
        inject("scheduler.mixed")
        row_slot = np.zeros((R,), np.int32)
        row_start = np.zeros((R,), np.int32)
        row_len = np.zeros((R,), np.int32)
        row_from_device = np.zeros((R,), bool)
        row_arm = np.zeros((R,), bool)
        temp = np.zeros((R,), np.float32)
        top_p = np.ones((R,), np.float32)
        top_k = np.zeros((R,), np.int32)
        packed: list[int] = []
        tok_row: list[int] = []
        completions: list[tuple[int, SequenceHandle, int]] = []  # (row, handle, epoch)
        prefill_rows: list[tuple[int, SequenceHandle]] = []
        job_rows: list[tuple[int, _PrefixJob]] = []
        plain_rows: list[tuple[int, int, SequenceHandle, int]] = []
        constrained_decode: list[tuple[int, int, SequenceHandle, int]] = []
        constrained_rows: list[int] = []  # rows whose logits the host needs
        i = 0
        for h in batch:
            chunk = h.prompt_ids[h.prefill_pos : h.prefill_pos + C]
            row_slot[i] = h.slot
            row_start[i] = h.prefill_pos
            row_len[i] = len(chunk)
            packed += chunk
            tok_row += [i] * len(chunk)
            if not h.held and h.prefill_pos + len(chunk) >= len(h.prompt_ids):
                # prompt completes this chunk: arm the row so its first
                # token samples on the device with the sequence's params (a
                # constrained one keeps the defaults: the pick replaces it)
                row_arm[i] = True
                completions.append((i, h, h.epoch))
                if h.constraint is not None:
                    constrained_rows.append(i)
                else:
                    s = h.sampling
                    temp[i], top_p[i], top_k[i] = s.temperature, s.top_p, s.top_k
            prefill_rows.append((i, h))
            i += 1
        for job in jobs:
            chunk = job.ids[job.pos : job.pos + C]
            row_slot[i] = job.slot
            row_start[i] = job.pos
            row_len[i] = len(chunk)
            packed += chunk
            tok_row += [i] * len(chunk)
            job_rows.append((i, job))
            i += 1
        for slot, h, epoch in decode_members:
            row_slot[i] = slot
            row_from_device[i] = True
            row_arm[i] = True
            row_len[i] = 1
            packed.append(0)
            tok_row.append(i)
            if h.constraint is not None:
                # the host pick from this row's logits lands before the
                # slot's next dispatch (the round is depth-1)
                constrained_rows.append(i)
                constrained_decode.append((i, slot, h, epoch))
            else:
                s = h.sampling
                temp[i], top_p[i], top_k[i] = s.temperature, s.top_p, s.top_k
                plain_rows.append((i, slot, h, epoch))
            i += 1
        assert i <= B
        T = eng.ragged_bucket(len(packed))
        packed += [0] * (T - len(packed))
        tok_row += [R] * (T - len(tok_row))
        with Timer(self.metrics, "finchat_mixed_step_seconds") as mt:
            emitted_dev, _n_em, row_logits = eng.ragged_mixed(
                np.asarray(packed, np.int32), np.asarray(tok_row, np.int32),
                row_slot, row_start, row_len, row_from_device, row_arm,
                temp, top_p, top_k,
            )
        self._tally_dispatch()
        if TRACER.enabled:
            trows = [[h.slot, h.trace_id or h.seq_id, "prefill"] for _i, h in prefill_rows]
            trows += [[j.slot, f"prefix:{j.owner}", "prefix"] for _i, j in job_rows]
            trows += [[slot, h.trace_id or h.seq_id, "constrained"]
                      for _i, slot, h, _e in constrained_decode]
            trows += [[slot, h.trace_id or h.seq_id, "decode"] for _i, slot, h, _e in plain_rows]
            self._trace_dispatch("ragged", trows, ts=mt.started, dur=mt.elapsed)
        for idx, h in prefill_rows:
            h.prefill_pos += int(row_len[idx])
        for idx, job in job_rows:
            job.pos += int(row_len[idx])
            if job.pos >= job.shared_len:
                self._complete_prefix_job(job, "ragged")
        # only the constrained rows' logits cross to the host
        picked = eng.select_rows(row_logits, constrained_rows) if constrained_rows else None
        emitted, logits_host = await asyncio.to_thread(
            lambda: (eng.to_host(emitted_dev),
                     eng.to_host(picked) if picked is not None else None))
        for idx, handle, epoch in completions:
            if handle.finished or handle.epoch != epoch:
                continue  # cancelled or preempted while fetching
            handle.span.mark("prefill_done")
            try:
                if handle.constraint is not None:
                    token = self._constrained_pick(
                        handle, logits_host[constrained_rows.index(idx)])
                else:
                    token = int(emitted[idx, 0])
                self.prefilling.remove(handle)
                self.decoding[handle.slot] = handle
                self._deliver(handle, token)
            except Exception as e:  # per-sequence isolation
                logger.error("prefill completion error for %s: %s", handle.seq_id, e)
                self._evict(handle, "error", error=str(e))
        for idx, slot, handle, epoch in constrained_decode:
            if handle.finished or handle.slot != slot or handle.epoch != epoch:
                continue
            self._deliver(handle, self._constrained_pick(
                handle, logits_host[constrained_rows.index(idx)]))
        for idx, slot, handle, epoch in plain_rows:
            if handle.finished or handle.slot != slot or handle.epoch != epoch:
                continue
            self._deliver(handle, int(emitted[idx, 0]))
        self.metrics.set_gauge("finchat_batch_occupancy", len(self.decoding))

    def _deliver(self, handle: SequenceHandle, token_id: int) -> None:
        now = time.perf_counter()
        if handle.last_token_at is not None:
            self.metrics.observe(
                "finchat_inter_token_seconds", now - handle.last_token_at,
                labels={"prefill_concurrent": "yes" if self._iter_ran_prefill else "no"},
            )
        handle.last_token_at = now
        handle._emit_first_token_metrics()
        handle.generated += 1
        handle.history.append(token_id)
        self.metrics.inc("finchat_tokens_generated_total")
        if token_id == self.eos_id:
            self._evict(handle, "eos")
        elif handle.generated >= handle.sampling.max_new_tokens:
            handle.events.put_nowait({"type": "token", "token_id": token_id})
            self._evict(handle, "length")
        else:
            handle.events.put_nowait({"type": "token", "token_id": token_id})

    def _dispatch_decode(self, exclude: set[int] | frozenset = frozenset()) -> _InFlightStep:
        """Enqueue one decode step on the device without syncing. Slots in
        ``exclude`` (constrained slots whose pick is still pending) sit it
        out: inactive, their pages read and not written, their context and
        last token unchanged. The step's logits come back only while a
        constrained slot is in it, and only that slot's rows: ``[n, vocab]``,
        selected on the device, not the batch's ``[max_seqs, vocab]``."""
        inject("scheduler.decode")
        eng = self.engine
        B = eng.engine_cfg.max_seqs
        active = np.zeros((B,), bool)
        members = []
        for slot, handle in self.decoding.items():
            if slot in exclude:
                continue
            active[slot] = True
            members.append((slot, handle, handle.epoch))
        constrained_slots = sorted(slot for slot, h, _e in members if h.constraint is not None)
        logits = None
        if constrained_slots:
            next_tokens, logits = eng.decode(active, self._temperature, self._top_p,
                                             self._top_k, return_logits=True)
            logits = eng.select_rows(logits, constrained_slots)
        else:
            next_tokens = eng.decode(active, self._temperature, self._top_p, self._top_k)
        self._tally_dispatch()
        if TRACER.enabled:
            self._trace_dispatch("decode", [[slot, h.trace_id or h.seq_id, "decode"]
                                            for slot, h, _e in members])
        return _InFlightStep(tokens=next_tokens, logits=logits, members=members,
                             constrained_slots=constrained_slots)

    async def _consume_step(self, step: _InFlightStep) -> None:
        """Fetch a dispatched step's tokens and constrained logits rows (in a
        worker thread) and deliver them to the sequences that were in the
        batch when it was dispatched; a constrained member's token is the
        host pick from its row."""
        eng = self.engine
        tokens_host, logits_host = await asyncio.to_thread(
            lambda: (eng.to_host(step.tokens),
                     eng.to_host(step.logits) if step.logits is not None else None))
        for slot, handle, epoch in step.members:
            if handle.finished or handle.slot != slot or handle.epoch != epoch:
                continue  # evicted, cancelled or preempted since dispatch
            if handle.constraint is not None and logits_host is not None:
                token = self._constrained_pick(
                    handle, logits_host[step.constrained_slots.index(slot)])
                self._deliver(handle, token)
            else:
                self._deliver(handle, int(tokens_host[slot]))
        self.metrics.set_gauge("finchat_batch_occupancy", len(self.decoding))

    async def _drain_inflight(self, inflight: _InFlightStep) -> None:
        """Consume an in-flight step outside the decode try-block (idle
        drain, before a ragged round, before a preemption), turning a
        failure into the whole-round path. A failed consume is never
        retried: the replay recomputes what was not delivered. Returns None
        (the caller's new ``inflight``)."""
        try:
            await self._consume_step(inflight)
            self._note_round_ok("decode")
        except Exception as e:
            logger.error("in-flight step consume error: %s", e)
            await self._round_failed("decode", str(e))
        return None

    async def _loop(self) -> None:
        logger.info("scheduler loop started (max_seqs=%d, quant=%s)",
                    self.engine.engine_cfg.max_seqs, self.quant_label)
        inflight: _InFlightStep | None = None
        while self._running:
            self._reap_stale_holds()
            if self._coexist_mark is not None:
                self.metrics.inc("finchat_coexist_dispatches_total",
                                 self._dispatch_tally - self._coexist_mark)
                self._coexist_mark = None
            # parked holds are not work: the loop sleeps through a retrieval
            if not (self.pending or self.decoding or self._prefill_work()):
                if inflight is not None:  # drain the pipeline before idling
                    self._iter_ran_prefill = False
                    inflight = await self._drain_inflight(inflight)
                    continue
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass
                continue

            try:
                # page pressure: planned before any dispatch, carried out
                # only once the step in flight is drained, so no freed page
                # is still the target of a queued write
                victims = self._preemption_plan()
                if victims:
                    if inflight is not None:
                        inflight = await self._drain_inflight(inflight)
                        # consuming may have retired slots or freed pages (or
                        # on a failure preempted the victims already): plan again
                        victims = self._preemption_plan()
                    cand = self.pending[0].seq_id if self.pending else "?"
                    for victim in victims:
                        logger.info("page pressure: preempting %s (deadline %.3f) for %s",
                                    victim.seq_id, victim.deadline or float("inf"), cand)
                        self._preempt(victim)
                self._admit()
            except Exception as e:
                # admission never kills the loop (e.g. a device state lost
                # to a failed rebuild): log, back off, serve what still runs
                logger.error("admission error: %s", e)
                await asyncio.sleep(0.05)

            prefill_active = self._prefill_work()
            self._iter_ran_prefill = prefill_active
            if prefill_active and self.decoding:
                self.metrics.inc("finchat_coexist_iterations_total")
                self._coexist_mark = self._dispatch_tally

            if self._use_mixed():
                # the mixed path is depth-1 (dispatch + consume within the
                # iteration): drain any pipelined decode step first, which
                # also lands its pending picks
                if inflight is not None:
                    inflight = await self._drain_inflight(inflight)
                if self._use_mixed():  # consuming may have evicted slots
                    try:
                        await self._ragged_round()
                        self._note_round_ok("decode")
                        self._note_round_ok("prefill")
                    except Exception as e:
                        # the round's prefill rows and decode members rode
                        # one dispatch: they recover together
                        logger.error("mixed step error: %s", e)
                        await self._round_failed("mixed", str(e))
                    await asyncio.sleep(0)
                    continue

            if self._prefill_work():
                try:
                    await self._prefill_round()
                    self._note_round_ok("prefill")
                except Exception as e:
                    logger.error("prefill round error: %s", e)
                    await self._round_failed("prefill", str(e))

            if self.decoding:
                try:
                    # a decode round counts as OK only when a consume
                    # succeeded: a dispatch-only iteration (nothing in flight
                    # after a failure) must not reset the streak, or a device
                    # whose errors surface at the fetch would swing the
                    # streak 0-1-0 and never trip the breaker
                    consumed = False
                    # a constrained slot's next input is the host pick that
                    # lands when its step is consumed: it sits out the step
                    # dispatched before that consume and rejoins the next
                    pending = set(inflight.constrained_slots) if inflight is not None else set()
                    if any(slot not in pending for slot in self.decoding):
                        # depth-2 pipeline: dispatch N+1, then consume N — the
                        # device computes while the host delivers tokens
                        step = self._dispatch_decode(exclude=pending)
                        if inflight is not None:
                            await self._consume_step(inflight)
                            consumed = True
                        inflight = step
                    else:
                        # every decoding slot waits on a pick: drain, then
                        # run depth-1
                        if inflight is not None:
                            await self._consume_step(inflight)
                            inflight = None
                            consumed = True
                        if self.decoding:
                            await self._consume_step(self._dispatch_decode())
                            consumed = True
                    if consumed:
                        self._note_round_ok("decode")
                except Exception as e:
                    # a whole-batch failure: every in-flight decode recovers
                    # together, and the dropped step is never consumed again
                    logger.error("decode step error: %s", e)
                    inflight = None
                    await self._round_failed("decode", str(e))
            elif inflight is not None:
                inflight = await self._drain_inflight(inflight)

            await asyncio.sleep(0)  # let producers/consumers run
        # a step still in flight is dropped, as in the reference: its
        # members are either finished or about to be failed by
        # shutdown_drain, whose offload covers what was delivered
        logger.info("scheduler loop stopped")
