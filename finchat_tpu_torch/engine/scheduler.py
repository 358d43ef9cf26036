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

- Fused multi-step decode (``decode_loop_depth`` K > 1): slots that need
  no per-token host control ride ``decode_loop_step`` blocks, K iterations
  with on-device sampling and the EOS stop mask in one dispatch (one CUDA
  graph replay on the card), the host fetching a ``[K, max_seqs]`` block a
  round trip. It composes with the depth-2 pipeline. Grammar-constrained
  slots and slots within K tokens of their budget are demoted to a single
  step riding the same iteration; a slot that finishes mid-block runs into
  the trash page and its tail counts as waste. In the ragged round a
  loop-eligible decode row runs the same K-1 iterations as a fused tail.
- Speculative decode (``spec_tokens`` > 0, engine/spec.py): greedy slots
  propose drafts from their own history (prompt lookup) and a depth-1
  verify step commits the accepted prefix plus one token; in the ragged
  round the drafts ride as rows of 1 + Kd tokens. After
  ``SPEC_MISS_DEMOTE`` consecutive steps with nothing accepted the loop
  goes back to the pipelined path for ``SPEC_RETRY_EVERY`` steps.
- The free-running loop (``freerun_rounds`` F > 1): when the ragged path
  runs and no row needs a host decision a round (no constrained row, no
  live spec proposal), up to F ragged rounds are staged
  (``ops/freerun.stage_freerun``) and enqueued as one dispatch
  (``engine.ragged_multi``); EOS stops on the device, budget stops are
  staged away, and the host drains the token ring while the device runs
  the next capture. Stale ring tokens (a member evicted or preempted since
  the dispatch) are dropped once and recomputed by the replay.

- Bounded KV (``kv_sink_pages`` / ``kv_window_pages``, the engine's
  ``BoundedKVPolicy``): between dispatches an eviction wave drops the
  oldest post-sink pages of any row whose next dispatch would not fit its
  sink + window page list, and records the evicted tokens as the row's
  ``kv_gap`` (mirrored in the engine's ``state.kv_gaps``; every write and
  mask runs at compacted positions). The schedule's only input is
  ``kv_ctx``, the row's context after every dispatched step, advanced at
  each dispatch site, so the gap a token sees is a function of its
  position alone: fused blocks and spec spans are gated to stay inside the
  next eviction boundary, free-run captures are capped at it, a bounded
  row preempts by snapshotting its surviving pages, and a gapped session
  entry resumes whole or salvages its sink.

The quantized plane (int8/int4 weights, int8 KV pages) is served: the
scheduler keeps the engine's quant label and sets the
``finchat_quant_weight_bits`` / ``finchat_quant_kv_bits`` gauges.

- Fleet identity and drain (serve/fleet.py): ``replica_id`` stamps the
  fault sites and the trace track, ``metrics`` (a
  ``METRICS.labeled(replica=...)`` view) labels every family. With a
  ``drain_sink`` a breaker trip, and a give-up, hand every preempted stream
  and its conversation's session bytes to a sibling replica; ``revive``
  brings a given-up replica back. With ``disagg`` set (serve/disagg.py)
  ``submit`` first runs a cold prompt's prefill on the prefill pool. A
  replica without the fabric keeps its session records in its own
  ``replica-<id>`` subdirectory of ``session_cache_disk_path``.
- The warm-state fabric (engine/warm_fabric.py, ``fabric=``): every
  replica's session tier is the fabric's one shared tier, so any replica
  resumes any conversation warm (``_restore_session_from_disk`` counts the
  fabric's hits and misses), and a shared prompt head is prefilled once a
  fleet: ``register_prefix`` restores a head the fabric holds with one
  scatter into the reserved pages, and publishes a head it prefilled.
- The pod plane (serve/pod.py): with ``pod`` set, ``submit`` first asks the
  coordinator to pull the conversation's newest session record from a peer
  host when nothing local resumes it warm.
- Sequence parallelism (an engine over a mesh with ``seq > 1``): a prompt
  of at least ``ring_prefill_min_tokens`` tokens prefills with its sequence
  split over the seq ranks (``_ring_routed``), in one shot
  (``engine.prefill_ring``, ``ring_prefill_chunk = 0``) or one segment a
  round (``engine.prefill_ring_segment``), so decode steps interleave
  between segments. A monolithic ring prompt skips prefix matching, a
  segmented one keeps the shared head (its first segment starts past it),
  and a ring prompt never resumes a session. When decode coexists, a
  ring-routed prompt rides the packed ragged round as ordinary chunk rows;
  the seq-sharded steps run only on the split path.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from finchat_tpu_torch.engine.engine import DEVICE_STATE_LOCK, InferenceEngine, round_up_pow2
from finchat_tpu_torch.engine.kv_cache import PageAllocationError, PageAllocator, pages_needed
from finchat_tpu_torch.engine.sampler import CANDIDATES, SamplingParams
from finchat_tpu_torch.engine.spec import NgramIndex
from finchat_tpu_torch.engine.session_cache import (
    SessionDiskTier,
    SessionEntry,
    SessionKVCache,
    concat_snaps,
    snap_kv_mode,
)
from finchat_tpu_torch.ops.freerun import RowSpec, stage_freerun
from finchat_tpu_torch.utils.config import EngineConfig
from finchat_tpu_torch.utils.faults import inject
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS, Timer
from finchat_tpu_torch.utils.tracing import TRACER, RequestSpan

if TYPE_CHECKING:  # the engine does not import the agent layer at run time
    from finchat_tpu_torch.agent.constrained import TokenConstraint

logger = get_logger(__name__)


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
    # on the segmented seq-sharded prefill (prefill_pos > 0 there means
    # "mid-ring", not "ride the chunked batch")
    ring_path: bool = False
    # completion deadline on time.perf_counter's clock; None = none. A
    # pending entry past it is shed, admission runs earliest deadline
    # first, and page pressure preempts the latest-deadline victim
    deadline: float | None = None
    # bounded KV: tokens evicted from this row's page list (whole pages
    # between the pinned sink and the surviving window; 0 = none), mirrored
    # in the engine's state.kv_gaps by the same wave
    kv_gap: int = 0
    # kv_ctx at the row's latest eviction wave (0 = never evicted): while it
    # exceeds the delivered context, an undelivered in-flight token was
    # computed under an older gap
    kv_gap_pos: int = 0
    # the slot's device context length after every DISPATCHED step,
    # advanced where each dispatch is built: the eviction schedule's only
    # input. At a wave it is exactly the next dispatch's write position, so
    # the gap a token sees depends on its position alone, whatever the
    # pipeline depth, capture depth or preempt boundary
    kv_ctx: int = 0
    # a bounded row's preempt snapshot: its surviving pages (sink + window,
    # compacted, the partial tail page included), restored by the replay,
    # which re-prefills only the residual tail; None otherwise
    bounded_snap: tuple | None = None
    bounded_snap_tokens: int = 0  # compacted tokens the snapshot covers
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
    # the incremental n-gram index over ``history`` (engine/spec.NgramIndex),
    # built at the slot's first spec step and kept in step by _deliver, so a
    # proposal is O(1) on the event loop
    ngram_index: NgramIndex | None = None

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
class _InFlightBlock:
    """A dispatched-but-unconsumed fused decode block: the ``[K, max_seqs]``
    device block of the loop-eligible slots, and the single decode step of
    the slots demoted in the same iteration (constrained, or within K of
    their budget), if any."""

    block_tokens: object  # [K, max_seqs] int32, device (-1 = no token)
    block_members: list[tuple[int, SequenceHandle, int]]
    step: _InFlightStep | None


@dataclass
class _InFlightRing:
    """A dispatched-but-unconsumed captured multi-round run: the token ring
    from ``engine.ragged_multi`` and the staged plan's host bookkeeping.
    Members carry the admission epoch, as an ``_InFlightStep``'s do: a row
    evicted or preempted while the capture was in flight has its ring
    tokens dropped at the drain, and its replay recomputes them, so
    delivery stays exactly-once."""

    tokens: object  # [F, R] int32, device — each armed row's round token
    n_emitted: object  # [F, R] int32, device (0 = mid-prompt chunk / dead row)
    blocks: object  # [F, K-1, max_seqs] int32, device — the fused tails
    rounds: int
    # (row, slot, owner, epoch, kind): owner a SequenceHandle for "prefill"
    # and "decode" rows, a _PrefixJob for "job" rows (no tokens)
    members: list
    armed: np.ndarray  # [F, R] staged arm mask, the exactly-once reference
    loop_rounds: np.ndarray  # [F, max_seqs] staged fused-tail schedule
    completes_at: dict  # row -> round its prompt completes (first token)
    ahead: dict  # slot -> staged emissions (the next dispatch's budget)


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
    # spec decode's all-miss demotion: after this many consecutive verify
    # steps with nothing accepted, the loop goes back to the pipelined
    # path...
    SPEC_MISS_DEMOTE = 4
    # ...and probes again after this many steps
    SPEC_RETRY_EVERY = 16
    # every label finchat_mixed_demotions_total can carry, pre-seeded at 0:
    # the ragged round takes spec rows, loop tails and constrained rows, so
    # none of them demotes it
    MIXED_DEMOTION_REASONS = ("spec", "decode_loop", "constrained", "ring", "other")
    # every reason a free-run capture is cut to one host-stepped round,
    # pre-seeded at 0 when the loop is on
    FREERUN_CAP_REASONS = ("constrained", "spec", "underfill", "boundedkv")

    def __init__(self, engine: InferenceEngine, eos_id: int, metrics=None,
                 replica_id: str | None = None, fabric=None):
        cfg = engine.engine_cfg
        self.engine = engine
        self.eos_id = eos_id
        # fleet identity: ``replica_id`` tags the fault sites (a drill can
        # wedge one replica) and ``metrics`` is a METRICS.labeled(replica=...)
        # view, so every family comes out per replica
        self.replica_id = replica_id
        self.metrics = metrics if metrics is not None else METRICS
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
        # the track of this engine's events on a trace timeline (one a
        # replica, so a fleet's timelines stay apart in one export)
        self._trace_track = f"replica-{replica_id}" if replica_id is not None else "engine"
        self.mixed_enabled = bool(cfg.mixed_step)
        for reason in self.MIXED_DEMOTION_REASONS:
            self.metrics.inc("finchat_mixed_demotions_total", 0.0, labels={"reason": reason})
        # speculative decode: > 0 turns the decode path into depth-1 verify
        # steps with Kd host-proposed drafts (a draft needs the previous
        # token on the host, which the depth-2 pipeline has not fetched)
        self.spec_k = cfg.spec_tokens
        self._spec_miss_streak = 0
        self._spec_cooldown = 0
        # fused multi-step decode: K > 1 turns the pipelined path into
        # K-token blocks for slots that need no per-token host control
        self.loop_depth = engine.decode_loop_depth
        self.metrics.set_gauge("finchat_decode_loop_depth", self.loop_depth)
        # the free-running loop: ragged rounds captured a dispatch (1 =
        # host-stepped). _round_tally counts serving rounds the way
        # _dispatch_tally counts dispatches (a capture books F rounds for
        # its one dispatch); both land in the coexist counters, so their
        # ratio is dispatches a round
        self.freerun_rounds = max(1, engine.freerun_rounds)
        self._round_tally = 0
        self._coexist_round_mark = 0
        if self.freerun_rounds > 1:
            for reason in self.FREERUN_CAP_REASONS:
                self.metrics.inc("finchat_freerun_capped_total", 0.0, labels={"reason": reason})
        self.max_queue_depth = max(0, cfg.max_queue_depth)
        # bounded KV: the engine's sink + window policy (None = unbounded).
        # The gauges show the configured shape and the counters render from
        # zero, so the first eviction wave (or recompute fallback) shows
        self.bounded_kv = engine.bounded_kv
        bp = self.bounded_kv
        self.metrics.set_gauge("finchat_boundedkv_sink_pages", bp.sink_pages if bp else 0)
        self.metrics.set_gauge("finchat_boundedkv_window_pages", bp.window_pages if bp else 0)
        self.metrics.inc("finchat_boundedkv_evicted_pages_total", 0.0)
        self.metrics.inc("finchat_boundedkv_bounded_sessions_total", 0.0)
        self.metrics.inc("finchat_boundedkv_recompute_fallbacks_total", 0.0)
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
        self.metrics.inc("finchat_quant_envelope_exceeded_total", 0.0)
        # the fused dequant-matmul plane: where the quantized matmuls run as
        # a gauge, and pre-seeded dispatch / fallback counters, so fused
        # engagement (or an inline-dequantized stacked expert leaf) shows
        # from zero per replica. The gauge keeps the JAX package's codes: 0
        # = the plain ``quant_matmul_ref`` (a CPU engine, or no quantized
        # weights), 2 = the Hopper kernels (a quantized engine on the card);
        # 1 (the JAX package's interpret mode) is never set, the port has
        # no interpret mode
        self._qm_fused = bool(engine.quant) and engine.device.type == "cuda"
        self.metrics.set_gauge("finchat_quantmatmul_backend", 2 if self._qm_fused else 0)
        self.metrics.inc("finchat_quantmatmul_fused_dispatches_total", 0.0)
        self.metrics.inc("finchat_quantmatmul_fallbacks_total", 0.0)
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
        # True from a give-up until revive(): the fleet router skips it
        self.gave_up = False
        # the fleet's drain sink (serve/fleet.py): a breaker trip offers every
        # preempted stream and its conversation's exported session bytes to
        # it, and a sibling replica that adopts one continues its stream;
        # ``(handle, session_payload) -> bool``
        self.drain_sink = None
        # the fleet's DisaggCoordinator (serve/disagg.py), set on serving-pool
        # schedulers only: submit runs a cold prompt's prefill through it
        self.disagg = None
        # the warm-state fabric (engine/warm_fabric.py): when set, the
        # session tier is the fleet's shared one and the shared heads restore
        # from and publish to it; None = the per-replica layout
        self.fabric = fabric
        # the app's PodCoordinator (serve/pod.py): submit asks it to pull a
        # conversation's session record from a peer host first
        self.pod = None
        if fabric is not None:
            # counted on this replica's view: hits and misses at a head's
            # registration and at a shared-tier restore, refusals of a head
            # snapshot of the other KV mode (a refused disk record counts on
            # the tier's own replica="fabric" view)
            self.metrics.inc("finchat_fabric_hits_total", 0.0)
            self.metrics.inc("finchat_fabric_misses_total", 0.0)
            self.metrics.inc("finchat_fabric_import_refused_total", 0.0)
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
            # a fleet replica keeps its records in its own subdirectory
            # (replica ids are stable across restarts; route-time migration
            # moves a conversation between replicas), unless the fabric is on:
            # then every replica shares the fabric's one tier
            disk = None
            disk_path = cfg.session_cache_disk_path
            if fabric is not None:
                disk = fabric.tier
            elif disk_path:
                if replica_id is not None:
                    disk_path = os.path.join(disk_path, f"replica-{replica_id}")
                try:
                    disk = SessionDiskTier(disk_path, cfg.session_cache_disk_bytes,
                                           metrics=self.metrics, kv_quant=engine.kv_quant)
                except Exception as e:  # durability is best-effort
                    logger.error("session disk tier unavailable at %s: %s", disk_path, e)
            self.session_cache = SessionKVCache(
                cfg.session_cache_bytes, page_size=cfg.page_size, on_drop=self._session_drop,
                metrics=self.metrics, disk=disk, fabric=fabric, fabric_replica=replica_id)

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
        if len(prompt_ids) + sampling.max_new_tokens > max_len and self.bounded_kv is None:
            # bounded KV lifts the bound: eviction keeps a row within its
            # sink + window pages whatever its length
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
        if self.disagg is not None and conversation_id:
            # disaggregated serving: a cold prompt prefills on the prefill
            # pool and its KV arrives through the session tier before
            # admission, so the match at admission resumes from it. Any
            # failure leaves the local prefill path, counted
            try:
                await self.disagg.maybe_prefill(self, prompt_ids, conversation_id,
                                                trace_id=trace_id)
            except Exception as e:
                logger.error("disagg handoff for %s failed: %s", conversation_id, e)
                self.metrics.inc("finchat_disagg_fallbacks_total",
                                 labels={"reason": "prefill_error"})
        if self.pod is not None and conversation_id:
            # the pod plane: a conversation another host may have served
            # pulls its newest session record over the liaison before
            # admission, so the match at admission resumes from it. Every
            # failure inside is a counted cold start, never an error here
            try:
                await self.pod.maybe_pull(self, conversation_id, trace_id=trace_id)
            except Exception as e:
                logger.error("pod session pull for %s failed: %s", conversation_id, e)
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
        path (empty, over budget, or long enough for the seq-sharded
        prefill, which owns its prompt from end to end); the caller then
        submits the full prompt."""
        if not prefix_ids:
            return None
        max_len = self.engine.max_pages_per_seq * self.engine.page_size
        if len(prefix_ids) + sampling.max_new_tokens > max_len:
            return None  # the full prompt could never fit either
        if self.engine._use_ring_prefill(len(prefix_ids)):
            return None
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
        if (len(full_ids) + handle.sampling.max_new_tokens > max_len
                and self.bounded_kv is None):
            self.metrics.inc("finchat_partial_fallbacks_total")
            return False
        if handle.slot >= 0:
            total = pages_needed(len(full_ids) + handle.sampling.max_new_tokens,
                                 self.engine.page_size)
            if self.bounded_kv is not None:
                total = min(total, self.bounded_kv.budget_pages)
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
        if self._fabric_restore_head(ids, shared_len, pages):
            # a fabric hit: the head's KV scattered into the reserved pages,
            # no prefill dispatch, the slot never used
            self.free_slots.append(slot)
            self._prefixes.append(_PrefixEntry(ids, pages, shared_len, owner))
            return shared_len
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
        self._fabric_store_head(ids, pages)
        logger.info("prefix cache: registered %d shared tokens (%d pages)",
                    shared_len, len(pages))
        return shared_len

    def _fabric_restore_head(self, ids: list[int], shared_len: int, pages: list[int]) -> bool:
        """Serve a head registration from the warm-state fabric: a hit
        scatters the fleet's snapshot into the reserved ``pages``, in place,
        instead of running the prefill. Hits, misses and refusals count on
        this replica's view; a snapshot of the other KV mode is refused (a
        scatter would cast it into garbage KV)."""
        if self.fabric is None:
            return False
        snap = self.fabric.load_head(ids)
        if snap is None:
            self.metrics.inc("finchat_fabric_misses_total")
            return False
        if snap_kv_mode(snap) != self.engine.kv_quant:
            self.metrics.inc("finchat_fabric_import_refused_total")
            return False
        try:
            t0 = time.perf_counter()
            # never beside a sibling's graph capture or pool rebuild
            with DEVICE_STATE_LOCK:
                self.engine.restore_pages(pages, snap)
        except Exception as e:
            logger.error("fabric head restore failed (%d tokens): %s — falling back to "
                         "local prefill", shared_len, e)
            return False
        self.metrics.inc("finchat_fabric_hits_total")
        self.metrics.observe("finchat_fabric_restore_seconds", time.perf_counter() - t0)
        if TRACER.enabled:
            TRACER.event("fabric_hit", track="fabric", args={"kind": "head", "tokens": shared_len})
        logger.info("prefix cache: head (%d shared tokens) restored from the warm fabric",
                    shared_len)
        return True

    def _fabric_store_head(self, ids: list[int], pages: list[int]) -> None:
        """Publish a freshly prefilled head fleet-wide (best-effort: the
        registration already succeeded)."""
        if self.fabric is None:
            return
        try:
            with DEVICE_STATE_LOCK:  # the snapshot's copy, as the restore's
                snap = self.engine.offload_pages(pages)
            self.fabric.store_head(ids, snap)
        except Exception as e:
            logger.error("fabric head publish failed: %s", e)

    def _prefix_prep(self, prompt_ids: list[int]):
        """What both registrations share: size the whole-page head, dedupe
        against live entries and jobs, reserve pages and an engine slot.
        Returns an int (0 = unregistrable or no capacity, or a registered
        entry's shared length) or ``(ids, shared_len, owner, pages, slot)``."""
        page = self.engine.page_size
        n_pages = min(len(prompt_ids) // page, self.engine.max_pages_per_seq)
        if self.bounded_kv is not None:
            # bounded rows reference at most the sink-sized lead of a head
            # (see _admit): pages registered past it would never be read
            n_pages = min(n_pages, self.bounded_kv.sink_pages)
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
        if self._fabric_restore_head(ids, shared_len, pages):
            # a fabric hit: one scatter, no chunked prefill rounds. This path
            # never writes the fabric: its chunked job retires pages piece by
            # piece, and a partial snapshot would be garbage
            self.free_slots.append(slot)
            self._prefixes.append(_PrefixEntry(ids, pages, shared_len, owner))
            return shared_len
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
        allocation), in compacted tokens (a bounded replay's ``kv_gap``
        tokens have no pages), capped at the bounded budget, where the
        eviction waves keep the row."""
        n = len(handle.prompt_ids) + self._remaining_new(handle) - handle.kv_gap
        total = pages_needed(n, self.engine.page_size)
        if self.bounded_kv is not None:
            total = min(total, self.bounded_kv.budget_pages)
        return total

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
        gap_rows: dict[int, int] = {}
        page = self.engine.page_size
        bp = self.bounded_kv
        while self.pending and self.free_slots:
            handle = self.pending[0]
            total = self._admission_pages(handle)
            if total > self.engine.max_pages_per_seq:
                break  # head-of-line waits (refused at submit anyway)
            bsnap = handle.bounded_snap
            if bsnap is not None:
                # a bounded replay: restore the surviving sink + window pages
                # from the preempt snapshot and re-prefill only the residual
                # tail. No prefix or session matching: the snapshot holds
                # the head region, and the evicted tokens have no pages
                session_eligible = False
                entry, shared_len = None, 0
                s_entry = None
                head_pages: list[int] = []
                ref_entry = None
                n_restore = -(-handle.bounded_snap_tokens // page)
                resume_pos = handle.bounded_snap_tokens + handle.kv_gap
                restore_snap = bsnap
                resume_gap = handle.kv_gap
            else:
                # a monolithic ring prefill starts at position 0, so it
                # matches no prefix (a hit would force the prompt onto the
                # chunked path); a segmented one keeps the shared head, its
                # first segment starting past it with the head folded in
                ring = bp is None and self.engine._use_ring_prefill(len(handle.prompt_ids))
                if ring and self.engine.ring_segment_tokens() == 0:
                    entry, shared_len = None, 0
                else:
                    entry, shared_len = self._match_prefix(handle.prompt_ids)
                if bp is not None and shared_len > bp.sink_tokens:
                    # bounded rows reference at most the sink-sized lead of a
                    # shared head: head pages pin whole (read-only references
                    # the wave cannot free), so a deeper head would pin more
                    # than the budget can make room around. The rest
                    # re-prefills and evicts like any other context
                    shared_len = bp.sink_tokens
                # session tier: a per-conversation resume takes over whenever
                # it matches deeper than the shared head (it holds the head
                # as its own leading pages); a ring prompt keeps the
                # seq-sharded prefill and takes no resume
                s_entry, s_matched = None, 0
                session_eligible = (self.session_cache is not None
                                    and bool(handle.conversation_id) and not ring)
                if session_eligible:
                    if self.session_cache.get(handle.conversation_id) is None:
                        # a RAM miss falls through to the disk tier; match()
                        # below then compares tokens and truncates as usual
                        self._restore_session_from_disk(handle.conversation_id)
                    s_entry, s_matched = self.session_cache.match(handle.conversation_id,
                                                                  handle.prompt_ids)
                    if s_entry is None or s_matched <= shared_len:
                        s_entry, s_matched = None, 0
                    if s_entry is not None and bp is None:
                        if s_entry.kv_gap:
                            # a gapped entry has no eviction machinery to
                            # live under on an unbounded engine: cold start
                            s_entry, s_matched = None, 0
                    elif (s_entry is not None
                            and (s_entry.prefix_len > bp.sink_tokens
                                 or pages_needed(s_matched - s_entry.kv_gap, page)
                                 > bp.budget_pages)):
                        # a resume whose head reference or restored pages
                        # exceed the bounded budget cannot be laid out
                        # (entries written by this bounded engine fit by
                        # construction): cold start
                        s_entry, s_matched = None, 0
                if s_entry is not None:
                    # head pages referenced (never copied); the pages past
                    # the head restore from the host snapshot below
                    head_pages = s_entry.prefix_pages[: min(s_matched, s_entry.prefix_len) // page]
                    n_restore = s_entry.own_pages_for(s_matched, page)
                    ref_entry = s_entry.prefix_entry if head_pages else None
                    resume_pos = s_matched
                    restore_snap = s_entry.snap
                    # a bounded entry resumes with its sink + window intact:
                    # the gap travels with the snapshot
                    resume_gap = s_entry.kv_gap
                else:
                    head_pages = entry.pages[: shared_len // page] if entry else []
                    n_restore = 0
                    ref_entry = entry
                    resume_pos = shared_len
                    restore_snap = None
                    resume_gap = 0
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
                        self.engine.restore_pages(pages[:n_restore], restore_snap)
                    self.metrics.inc("finchat_session_cache_restored_tokens_total", resume_pos)
                except Exception as e:
                    # a failed restore must neither kill the stream nor leak
                    # its pages: return them and start cold on the plain
                    # shared-prefix plan
                    logger.error("session cache restore failed for %s: %s", handle.seq_id, e)
                    self.allocator.free(handle.seq_id, pages)
                    if bsnap is not None:
                        # a bounded replay falls back to recomputing its
                        # whole history: the surviving bytes are gone, so
                        # the gap resets (counted)
                        handle.bounded_snap = None
                        handle.bounded_snap_tokens = 0
                        handle.kv_gap = 0
                        self.metrics.inc("finchat_boundedkv_recompute_fallbacks_total")
                        total = self._admission_pages(handle)
                    s_entry = None
                    resume_gap = 0
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
                else:
                    if bsnap is not None:
                        handle.bounded_snap = None
                        handle.bounded_snap_tokens = 0
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
            handle.kv_gap = resume_gap
            handle.kv_ctx = resume_pos
            if resume_gap:
                gap_rows[slot] = resume_gap
            if ref_entry is not None:
                ref_entry.refs += 1
                handle.prefix_entry = ref_entry
            if resume_pos:
                ctx_rows[slot] = resume_pos
                handle.prefill_pos = resume_pos
                if s_entry is None and bsnap is None:
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
            if gap_rows:
                self.engine.set_kv_gap_rows(gap_rows)
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
        # token, whose append belongs to a step that was never consumed. A
        # bounded row counts compacted tokens: the snapshot holds only the
        # surviving sink + window pages, and the entry records the gap
        gap = handle.kv_gap
        context = len(handle.history) - 1 - gap
        n_tok = (context // page) * page
        if n_tok <= 0:
            return
        shared = min(handle.shared_len, n_tok)
        # incremental offload: the pages of [shared, resumed_len) were
        # restored from the previous entry and never rewritten (the slot's
        # writes start at resumed_len), so reuse those host bytes. Gapped
        # rows re-copy (a bounded snapshot is at most sink + window pages)
        prev = cache.get(handle.conversation_id)
        reuse_pages = 0
        if (gap == 0 and prev is not None and prev.snap is not None and prev.kv_gap == 0
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
            # the token ids cover the absolute span [0, n_tok + gap): the
            # evicted tokens' ids must still match the next turn's prompt
            # for the surviving KV to be valid
            token_ids=np.asarray(handle.history[: n_tok + gap], np.int32),
            prefix_entry=handle.prefix_entry if shared else None,
            prefix_pages=list(handle.page_list[: shared // page]),
            prefix_len=shared,
            snap=concat_snaps(prev.snap if reuse_pages else None, reuse_pages, snap_new),
            kv_gap=gap,
            kv_sink=self.bounded_kv.sink_tokens if gap and self.bounded_kv is not None else 0,
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

    # --- bounded KV ---------------------------------------------------------
    def _bounded_pinned_pages(self, handle: SequenceHandle) -> int:
        """Unevictable leading pages of a bounded row: the sink, widened to
        the whole shared head when that is larger (head pages are
        read-only references the wave cannot free)."""
        return max(self.bounded_kv.sink_pages, handle.shared_len // self.engine.page_size)

    def _bounded_evict_wave(self) -> None:
        """Page-granular eviction between dispatches: a bounded row whose
        next dispatch would not fit its page list drops its oldest post-sink
        pages (they leave the logical page list, later pages shift down,
        nothing moves on the device), returns them to the pool and takes as
        many fresh tail pages for the incoming writes. ``kv_gap`` grows a
        page a page evicted, and the page table and ``state.kv_gaps`` are
        written in the same wave, in place: every dispatch enqueued after it
        sees a table and gap that agree, and stream order keeps a dispatch
        already in flight reading the table it was built against (the
        freed pages' next writers are enqueued after it too).

        The wave's only inputs are each row's ``kv_ctx`` and the config's
        reserve constants, so the gap a token is computed under depends on
        its position alone: a free-run capture (capped at the next
        boundary, ``_bounded_freerun_cap``) and a preempt replay see the
        host-stepped schedule."""
        bp = self.bounded_kv
        if bp is None:
            return
        page = self.engine.page_size
        chunk = self.engine.engine_cfg.prefill_chunk
        pt_rows: dict[int, list[int]] = {}
        gap_rows: dict[int, int] = {}
        evicted_total = 0
        for handle in list(self.prefilling) + list(self.decoding.values()):
            if handle.slot < 0 or handle.finished or self._parked(handle):
                continue
            # the reserve is what the next dispatch writes for this row: a
            # prefill chunk, or ONE decode token. Fused spans (loop tails,
            # spec verify rows) are gated to stay inside the boundary
            # (_bounded_span_room), so only a single token ever reaches it;
            # reserving the whole burst would evict a dispatch early where
            # the gate demotes, and a replay regrouping those positions
            # would see another schedule
            if handle.prefill_pos < len(handle.prompt_ids):
                incoming = min(chunk, len(handle.prompt_ids) - handle.prefill_pos)
            else:
                incoming = 1
            try:
                e = bp.plan_eviction(handle.kv_ctx - handle.kv_gap, incoming,
                                     len(handle.page_list), self._bounded_pinned_pages(handle))
            except PageAllocationError as err:
                # an infeasible plan is a policy violation for THIS row (a
                # shared head pinning almost the whole budget): it fails
                # alone, the others keep serving
                logger.error("bounded eviction infeasible for %s: %s", handle.seq_id, err)
                self._evict(handle, "error", error=str(err))
                continue
            if not e:
                continue
            if handle.kv_gap == 0:
                self.metrics.inc("finchat_boundedkv_bounded_sessions_total")
            pin = self._bounded_pinned_pages(handle)
            victims = handle.page_list[pin : pin + e]
            handle.page_list = handle.page_list[:pin] + handle.page_list[pin + e :]
            self.allocator.free(handle.seq_id, victims)
            # capacity stays constant: fresh tail pages for the incoming
            # writes (the LIFO free list usually hands the same pages back)
            handle.page_list = handle.page_list + self.allocator.allocate(handle.seq_id, e)
            handle.kv_gap += e * page
            handle.kv_gap_pos = handle.kv_ctx
            pt_rows[handle.slot] = handle.page_list
            gap_rows[handle.slot] = handle.kv_gap
            evicted_total += e
        if pt_rows:
            self.engine.set_page_table_rows(pt_rows)
            self.engine.set_kv_gap_rows(gap_rows)
            self.metrics.inc("finchat_boundedkv_evicted_pages_total", evicted_total)
            if TRACER.enabled:
                TRACER.event("boundedkv_evict", track=self._trace_track,
                             args={"pages": evicted_total, "slots": sorted(pt_rows)})

    def _bounded_span_room(self, handle: SequenceHandle) -> int:
        """Tokens this row may still write before its next eviction boundary
        (page-list capacity + ``kv_gap``). A fused multi-token dispatch
        (a loop block or tail, a spec verify span) must fit it: a span
        crossing the boundary would give its tail the pre-eviction gap, and
        a replay or capture regrouping spans would then see another gap for
        the same position. Unbounded rows have unlimited room (their pages
        cover prompt + max_new)."""
        if self.bounded_kv is None:
            return 1 << 30
        boundary = len(handle.page_list) * self.engine.page_size + handle.kv_gap
        return max(0, boundary - handle.kv_ctx)

    def _bounded_freerun_cap(self) -> int:
        """Rounds the next capture may run before some bounded row needs an
        eviction wave: within it the staged writes fit every row's current
        page list, so the captured rounds see the host-stepped gap
        schedule."""
        cap = self.freerun_rounds
        if self.bounded_kv is None:
            return cap
        chunk = self.engine.engine_cfg.prefill_chunk
        decode_burst = 1 + max(self.loop_depth - 1, self.spec_k)
        for handle in list(self.prefilling) + list(self.decoding.values()):
            if handle.slot < 0 or handle.finished or self._parked(handle):
                continue
            room = self._bounded_span_room(handle)
            # a prefill row may turn into a decode row mid-capture: the
            # larger of a chunk and a decode burst bounds both roles' writes
            prefilling = handle.prefill_pos < len(handle.prompt_ids)
            per_round = max(chunk, decode_burst) if prefilling else decode_burst
            cap = min(cap, max(1, room // max(1, per_round)))
        return cap

    def _bounded_preempt_snapshot(self, handle: SequenceHandle, for_rebuild: bool) -> None:
        """Snapshot a bounded row's surviving pages for its replay (see
        ``_preempt``). A ``for_rebuild`` preempt runs against a possibly
        wedged device: no snapshot is tried, and the row falls back to
        recomputing its whole history (gap reset; tokens past the window
        may then differ from the uninterrupted stream; counted).

        The snapshot covers the exact compacted context, the partial tail
        page included: the tail tokens' KV was computed against pages that
        may since have been evicted, so recomputing them would attend
        another set. Only the last history token (whose KV belongs to the
        never-consumed step) re-prefills. This holds for a preempt taken at
        a consumed boundary (``kv_gap_pos <= len(history) - 1``), as the
        page-pressure path's is (it drains the dispatch in flight first);
        a preempt inside an eviction transition recomputes the boundary
        token under the newer gap, a valid bounded decode."""
        page = self.engine.page_size
        snap_tokens = len(handle.history) - 1 - handle.kv_gap
        if not for_rebuild and snap_tokens > 0:
            try:
                n = -(-snap_tokens // page)  # whole pages, the partial tail included
                handle.bounded_snap = self.engine.offload_pages(handle.page_list[:n])
                handle.bounded_snap_tokens = snap_tokens
                return
            except Exception as e:
                logger.error("bounded preempt snapshot failed for %s: %s", handle.seq_id, e)
        handle.bounded_snap = None
        handle.bounded_snap_tokens = 0
        handle.kv_gap = 0
        self.metrics.inc("finchat_boundedkv_recompute_fallbacks_total")

    # --- recompute preemption ---------------------------------------------
    def _preempt(self, handle: SequenceHandle, *, for_rebuild: bool = False) -> None:
        """Free the victim's slot and KV pages but keep its prompt and
        generated tokens on the handle: the replay sets ``prompt_ids`` to
        the history, so re-admission re-prefills exactly the stream so far
        (through the shared-prefix and session caches, which usually makes
        it cheap) and its first commit samples exactly the next token. A
        token of the victim still riding a dispatch is dropped at consume
        time (the epoch moved) and recomputed by the replay.

        A bounded row that has evicted preempts by snapshot instead
        (``_bounded_preempt_snapshot``): its surviving pages go to the host
        and the replay restores them.

        Used for page pressure and as the breaker's recovery primitive;
        ``for_rebuild`` skips the per-slot device reset (the whole device
        state is about to be replaced, and the engine may be wedged)."""
        if handle.finished:
            return
        slot = handle.slot
        if slot >= 0:
            if self.bounded_kv is not None and handle.kv_gap:
                # a bounded row preempts by snapshot, not recompute: the
                # window's KV attended to tokens that are gone, so it cannot
                # be recomputed from the token stream. Its surviving pages go
                # to the host before they free; the replay restores them
                self._bounded_preempt_snapshot(handle, for_rebuild)
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
        handle.kv_ctx = 0
        handle.page_list = []
        handle.shared_len = 0
        handle.resumed_len = 0
        handle.ring_path = False
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
        # the plan _admit will make: a head the candidate shares needs no
        # pages (a monolithic ring prompt shares none)
        ring = self.engine._use_ring_prefill(len(cand.prompt_ids))
        if ring and self.engine.ring_segment_tokens() == 0:
            shared_len = 0
        else:
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
    def _drain_to_sink(self) -> int:
        """Offer every pending handle (the just-preempted live streams and
        the queued, never-admitted ones) to the fleet's drain sink with its
        conversation's exported session bytes. An adopted handle leaves this
        scheduler, and its session entry goes with it. Runs before the trip
        purges the caches that refer to device pages (the export must still
        see the entries). Held overlap handles are skipped: their
        ``extend_prompt`` seam is bound to this scheduler, and they replay
        here. Returns how many were adopted."""
        sink = self.drain_sink
        if sink is None:
            return 0
        adopted = 0
        for handle in list(self.pending):
            if handle.held:
                continue
            payload = None
            try:
                payload = self.export_session(handle.conversation_id)
            except Exception as e:
                logger.error("session export failed for %s: %s", handle.conversation_id, e)
            try:
                taken = bool(sink(handle, payload))
            except Exception as e:
                logger.error("drain sink failed for %s: %s", handle.seq_id, e)
                taken = False
            if taken:
                self.pending.remove(handle)
                if handle.conversation_id and self.session_cache is not None:
                    # the bytes moved with the stream: a source copy left
                    # here could resume a later divergent turn stale
                    self.session_cache.discard(handle.conversation_id)
                adopted += 1
        self.metrics.set_gauge("finchat_queue_depth", len(self.pending))
        return adopted

    def revive(self) -> bool:
        """Rebuild a given-up scheduler's device state from a clean slate
        on the calling thread (the fleet supervisor runs ``revive_async``).
        Only callable with nothing live here. Returns True when the engine
        is serving again."""
        self._revive_prepare()
        if not self._revive_rebuild():
            return False
        self._revive_commit()
        return True

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
            raise RuntimeError("revive() with live sequences; drain first")
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
            inject("engine.rebuild", replica=self.replica_id)
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
        ("prefill", or "decode" for decode, mixed and spec rounds) advances; below
        the threshold the round's sequences are preempted and replay, at the
        threshold the breaker trips (``_trip_breaker``). A failed dispatch
        is never consumed again: a partly consumed step cannot be told from
        an unconsumed one, and the replay recomputes what was not
        delivered."""
        self.metrics.inc("finchat_dispatch_failures_total")
        if self.breaker_threshold <= 0:
            if scope in ("prefill", "mixed"):
                self._fail_prefill_round(error)
            if scope in ("decode", "mixed", "spec"):
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
        if scope in ("decode", "mixed", "spec"):
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
                "replica": self.replica_id,
                "rebuilds": self._rebuilds_without_success - 1,
            })
            if self.drain_sink is not None:
                # a fleet give-up: the streams go on on siblings. Every live
                # sequence is preempted to the host and offered to the sink;
                # what no sibling adopts fails with the retryable error
                logger.error("breaker: giving up after %d rebuilds; draining %d live "
                             "sequences to sibling replicas (%s)",
                             self._rebuilds_without_success - 1,
                             len(self.decoding) + len(self.prefilling), error)
                for handle in list(self.decoding.values()) + list(self.prefilling):
                    try:
                        self._preempt(handle, for_rebuild=True)
                    except Exception as e:
                        logger.error("preempting %s at breaker give-up: %s", handle.seq_id, e)
                self._drain_to_sink()
                # whatever was not adopted (preempted streams, held overlap
                # handles, never-admitted queue entries) fails now: this
                # replica goes OUT, and work left queued here would burn
                # another fail streak per handle on a wedged engine
                for handle in list(self.pending):
                    self.pending.remove(handle)
                    # the one site counting a drain failure, once per stream;
                    # a fleet-level series, unlabeled like every finchat_fleet_*
                    METRICS.inc("finchat_fleet_drain_failures_total")
                    handle.finished = True
                    handle.span.finish()
                    handle.events.put_nowait({
                        "type": "error", "message": error,
                        "code": "replica_out", "retryable": True,
                    })
                # an OUT replica exports no phantom backlog
                self.metrics.set_gauge("finchat_queue_depth", len(self.pending))
            else:
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
            "replica": self.replica_id, "dispatch_tally": self._dispatch_tally,
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
        if self.drain_sink is not None:
            # fleet drain: the preempted streams and their conversations'
            # session bytes go to siblings now, before the purge below drops
            # the entries, so they go on there while this replica rebuilds;
            # what no sibling adopts stays pending and replays here
            adopted = self._drain_to_sink()
            if adopted:
                logger.info("breaker drain: %d streams adopted by siblings", adopted)
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
        registration of the same head, refcounted like a local offload. A
        gapped entry (``kv_gap``, written under bounded KV) is taken by a
        bounded engine and resumes whole or salvages its sink. No matching
        live head, a gapped entry on an unbounded engine (it has no eviction
        machinery to live under), or a snapshot of the other page-pool
        dtype refuses it (counted) and the conversation resumes cold."""
        if payload is None or self.session_cache is None:
            return False
        if payload.get("kv_gap") and self.bounded_kv is None:
            logger.warning("session import for %s refused: a bounded-KV entry (kv_gap %d) on "
                           "an unbounded engine — cold start", payload.get("conversation_id"),
                           payload["kv_gap"])
            METRICS.inc("finchat_fleet_session_import_refused_total")
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
                # a fleet-level series, unlabeled like every finchat_fleet_*
                METRICS.inc("finchat_fleet_session_import_refused_total")
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
        if cache is None or cache.disk is None:
            return False
        if conversation_id not in cache.disk:
            if self.fabric is not None:
                # the shared tier is the fleet-wide lookup: no replica ever
                # retired this conversation
                self.metrics.inc("finchat_fabric_misses_total")
            return False
        t0 = time.perf_counter()
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
            if self.fabric is not None:
                # off the fleet-shared tier: any replica's retirement (or a
                # handoff) may have written it, and this one resumes it warm
                self.metrics.inc("finchat_fabric_hits_total")
                self.metrics.observe("finchat_fabric_restore_seconds", time.perf_counter() - t0)
                if TRACER.enabled:
                    TRACER.event("fabric_hit", track="fabric",
                                 args={"kind": "session", "key": conversation_id})
        elif self.fabric is not None:
            self.metrics.inc("finchat_fabric_misses_total")
        return ok

    def spill_sessions(self) -> int:
        """Write every resident session entry through to the disk tier and
        wait for the writes (graceful shutdown)."""
        if self.session_cache is None:
            return 0
        return self.session_cache.spill_all()

    def _tally_dispatch(self) -> None:
        """Count one model dispatch (the coexist attribution); an engine
        whose quantized matmuls go to the kernels also books it on
        ``finchat_quantmatmul_fused_dispatches_total``: every model dispatch
        of that engine reads packed weights."""
        self._dispatch_tally += 1
        if self._qm_fused:
            self.metrics.inc("finchat_quantmatmul_fused_dispatches_total")

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

    def _ring_routed(self, handle: SequenceHandle) -> bool:
        """Does this prefilling handle take the seq-sharded prefill this
        round (``prefill_ring`` / ``prefill_ring_segment``) rather than the
        chunked batch? Bounded rows never do (the seq-sharded steps write at
        absolute positions, and a segment's burst exceeds the eviction
        wave's reserve), nor a grafted hold (both paths schedule the prompt
        from position 0); a handle does from position 0, on the ring path
        already, or with a shared-prefix entry."""
        return (self.bounded_kv is None
                and self.engine._use_ring_prefill(len(handle.prompt_ids))
                and not handle.grafted
                and (handle.prefill_pos == 0 or handle.ring_path
                     or handle.prefix_entry is not None))

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
        that sample nothing. A ring-routed prompt (``_ring_routed``) takes
        the seq-sharded prefill instead: the whole prompt in this round
        (``ring_prefill_chunk = 0``: every decoding stream waits for it), or
        its next segment."""
        eng = self.engine
        C = eng.engine_cfg.prefill_chunk
        batch = []
        # (handle, logits [N, vocab], row, epoch) of each prompt completed
        # this round: the epoch tells a preempted and replayed incarnation
        # from the one this round prefilled
        completions: list[tuple[SequenceHandle, object, int, int]] = []
        for handle in self._prefill_batch():
            if not self._ring_routed(handle):
                batch.append(handle)
                continue
            try:
                done = self._ring_step(handle)
            except Exception as e:  # per-sequence isolation
                logger.error("prefill error for %s: %s", handle.seq_id, e)
                self._evict(handle, "error", error=str(e))
                continue
            if done is not None:
                completions.append((handle, done[None], 0, handle.epoch))
        jobs = list(self._prefix_jobs)
        if batch or jobs:
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
            for i, handle in enumerate(batch):
                handle.prefill_pos += int(n_valids[i])
                handle.kv_ctx = handle.prefill_pos
                if handle.prefill_pos >= len(handle.prompt_ids):
                    if handle.held:
                        continue  # park: the first token waits for the graft
                    completions.append((handle, logits, i, handle.epoch))
            for i, job in enumerate(jobs, start=len(batch)):
                job.pos += int(n_valids[i])
                if job.pos >= job.shared_len:
                    self._complete_prefix_job(job, "chunked")
        if not completions:
            return  # dispatch-only round, no host sync needed
        tokens_dev = []
        for h, lg, i, _epoch in completions:
            h.span.mark("prefill_done")
            s = h.sampling
            tokens_dev.append(eng.commit_first_token(h.slot, lg[i], s.temperature,
                                                     s.top_p, s.top_k))
        # only the constrained completions' logits rows leave the card, the
        # rows of each logits tensor selected on the device together
        picks: dict[int, tuple[object, list[int]]] = {}
        for h, lg, i, _epoch in completions:
            if h.constraint is not None:
                picks.setdefault(id(lg), (lg, []))[1].append(i)
        picked = [eng.select_rows(lg, rows) for lg, rows in picks.values()]
        # one host fetch for all completions (worker thread keeps the loop live)
        fetched, picked_host = await asyncio.to_thread(
            lambda: ([int(eng.to_host(t)) for t in tokens_dev],
                     [eng.to_host(p) for p in picked]))
        logits_host = {(key, i): host[r] for (key, (_lg, rows)), host
                       in zip(picks.items(), picked_host) for r, i in enumerate(rows)}
        for (handle, lg, i, epoch), token_id in zip(completions, fetched):
            if handle.finished or handle.epoch != epoch:
                continue  # cancelled or preempted while fetching
            try:
                if handle.constraint is not None:
                    token_id = self._constrained_pick(handle, logits_host[(id(lg), i)])
                self.prefilling.remove(handle)
                self.decoding[handle.slot] = handle
                self._deliver(handle, int(token_id))
            except Exception as e:  # a pick or delivery error fails its sequence only
                logger.error("prefill completion error for %s: %s", handle.seq_id, e)
                self._evict(handle, "error", error=str(e))

    def _ring_step(self, handle: SequenceHandle):
        """One seq-sharded dispatch for a ring-routed handle: its whole
        prompt (monolithic), or its next segment, at its prefill position
        (a first segment past a shared head folds the head in). Returns the
        last token's logits [vocab] once the prompt is done, else None."""
        eng = self.engine
        rc = eng.ring_segment_tokens()
        if rc == 0:
            assert handle.prefill_pos == 0  # a monolithic ring matches no prefix (_admit)
            kind = "ring"
            with Timer(self.metrics, "finchat_prefill_seconds") as pt:
                logits = eng.prefill_ring(handle.slot, handle.prompt_ids)
            handle.prefill_pos = len(handle.prompt_ids)
        else:
            kind = "ring_segment"
            handle.ring_path = True
            seg = handle.prompt_ids[handle.prefill_pos:handle.prefill_pos + rc]
            with Timer(self.metrics, "finchat_prefill_seconds") as pt:
                logits = eng.prefill_ring_segment(handle.slot, seg, handle.prefill_pos)
            handle.prefill_pos += len(seg)
        self._tally_dispatch()
        if TRACER.enabled:
            self._trace_dispatch(kind, [[handle.slot, handle.trace_id or handle.seq_id, "ring"]],
                                 ts=pt.started, dur=pt.elapsed)
        handle.kv_ctx = handle.prefill_pos
        return logits if handle.prefill_pos >= len(handle.prompt_ids) else None

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
                inject("scheduler.prefill", seq_id=handle.seq_id, replica=self.replica_id)
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
        """Advance every serving population in ONE packed ragged dispatch,
        with one host fetch: prefilling sequences a chunk each, plain
        decode slots a token, constrained slots a token with their logits
        row returned for the host pick, spec-eligible slots a (1+Kd)-token
        verify row, and loop-eligible slots a further fused ``loop_depth -
        1``-token tail. Prefill rows whose prompt completes sample their
        first token on the device in the same dispatch (a completed hold
        parks instead); constrained completions and decode rows keep the
        non-truncating sampling defaults. Chunked prefix registrations ride
        it as rows that sample nothing."""
        eng = self.engine
        C = eng.engine_cfg.prefill_chunk
        R = B = eng.engine_cfg.max_seqs
        self._round_tally += 1  # one host-stepped serving round
        Kd = self.spec_k
        spec_on = Kd > 0 and self._spec_cooldown == 0
        batch = self._prefill_batch()
        jobs = list(self._prefix_jobs)
        decode_members = [(slot, h, h.epoch) for slot, h in self.decoding.items()]
        if (not batch and not jobs) or not decode_members:
            return  # a fault above drained one side; the split path goes on
        inject("scheduler.decode", replica=self.replica_id)
        # the ragged round's own site: fails this dispatch alone while the
        # split path stays healthy
        inject("scheduler.mixed", replica=self.replica_id)
        row_slot = np.zeros((R,), np.int32)
        row_start = np.zeros((R,), np.int32)
        row_len = np.zeros((R,), np.int32)
        row_from_device = np.zeros((R,), bool)
        row_arm = np.zeros((R,), bool)
        row_n_drafts = np.zeros((R,), np.int32)
        temp = np.zeros((R,), np.float32)
        top_p = np.ones((R,), np.float32)
        top_k = np.zeros((R,), np.int32)
        loop_active = np.zeros((B,), bool)
        packed: list[int] = []
        tok_row: list[int] = []
        completions: list[tuple[int, SequenceHandle, int]] = []  # (row, handle, epoch)
        prefill_rows: list[tuple[int, SequenceHandle]] = []
        job_rows: list[tuple[int, _PrefixJob]] = []
        plain_rows: list[tuple[int, int, SequenceHandle, int]] = []
        spec_rows: list[tuple[int, int, SequenceHandle, int]] = []
        constrained_decode: list[tuple[int, int, SequenceHandle, int]] = []
        constrained_rows: list[int] = []  # rows whose logits the host needs
        loop_members: list[tuple[int, SequenceHandle, int]] = []
        spec_consulted = False
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
            if h.constraint is not None:
                # the host pick from this row's logits lands before the
                # slot's next dispatch (the round is depth-1)
                row_len[i] = 1
                packed.append(0)
                tok_row.append(i)
                constrained_rows.append(i)
                constrained_decode.append((i, slot, h, epoch))
                h.kv_ctx += 1
                i += 1
                continue
            prop: list[int] = []
            if spec_on and self._spec_eligible(h):
                spec_consulted = True
                prop = self._propose(h)
            s = h.sampling
            temp[i], top_p[i], top_k[i] = s.temperature, s.top_p, s.top_k
            if prop:
                # a spec verify row: [device last token, d1..dKd'], the drafts
                # in the packed buffer, acceptance on the device
                row_len[i] = 1 + len(prop)
                row_n_drafts[i] = len(prop)
                packed.append(0)
                tok_row.append(i)
                packed += [int(t) for t in prop]
                tok_row += [i] * len(prop)
                spec_rows.append((i, slot, h, epoch))
                # the context advances by n_emitted (>= 1): the accepted
                # drafts land on kv_ctx at the consume below
                h.kv_ctx += 1
            else:
                row_len[i] = 1
                packed.append(0)
                tok_row.append(i)
                plain_rows.append((i, slot, h, epoch))
                if self.loop_depth > 1 and self._loop_eligible(h, 0):
                    # the fused tail in the same dispatch: the row's token
                    # plus loop_depth - 1 tail tokens fit the budget and the
                    # eviction-boundary room (checked before the bump: the
                    # span starts at the row's own write)
                    loop_active[slot] = True
                    loop_members.append((slot, h, epoch))
                    h.kv_ctx += self.loop_depth
                else:
                    h.kv_ctx += 1
            i += 1
        assert i <= B
        T = eng.ragged_bucket(len(packed))
        packed += [0] * (T - len(packed))
        tok_row += [R] * (T - len(tok_row))
        with Timer(self.metrics, "finchat_mixed_step_seconds") as mt:
            emitted_dev, n_em_dev, row_logits, block_dev = eng.ragged_mixed(
                np.asarray(packed, np.int32), np.asarray(tok_row, np.int32),
                row_slot, row_start, row_len, row_from_device, row_arm,
                temp, top_p, top_k, row_n_drafts, loop_active, self._temperature, self._top_p,
                self._top_k, self.eos_id,
            )
        self._tally_dispatch()
        if TRACER.enabled:
            trows = [[h.slot, h.trace_id or h.seq_id, "prefill"] for _i, h in prefill_rows]
            trows += [[j.slot, f"prefix:{j.owner}", "prefix"] for _i, j in job_rows]
            trows += [[slot, h.trace_id or h.seq_id, "constrained"]
                      for _i, slot, h, _e in constrained_decode]
            trows += [[slot, h.trace_id or h.seq_id,
                       "decode_loop" if loop_active[slot] else "decode"]
                      for _i, slot, h, _e in plain_rows]
            trows += [[slot, h.trace_id or h.seq_id, "spec"] for _i, slot, h, _e in spec_rows]
            self._trace_dispatch("ragged", trows, ts=mt.started, dur=mt.elapsed)
        for idx, h in prefill_rows:
            h.prefill_pos += int(row_len[idx])
            h.kv_ctx = h.prefill_pos
        for idx, job in job_rows:
            job.pos += int(row_len[idx])
            if job.pos >= job.shared_len:
                self._complete_prefix_job(job, "ragged")
        # only the constrained rows' logits cross to the host; ONE fetch
        # serves tokens, spec acceptances, first tokens and the tail block
        picked = eng.select_rows(row_logits, constrained_rows) if constrained_rows else None
        emitted, n_emitted, block, logits_host = await asyncio.to_thread(
            lambda: (eng.to_host(emitted_dev), eng.to_host(n_em_dev), eng.to_host(block_dev),
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
        accepted_total = 0
        for idx, slot, handle, epoch in spec_rows:
            if handle.finished or handle.slot != slot or handle.epoch != epoch:
                continue
            n = int(n_emitted[idx])
            handle.kv_ctx += max(0, n - 1)  # the accepted drafts' context advance
            accepted_total += max(0, n - 1)
            for token in emitted[idx, :n]:
                self._deliver(handle, int(token))
                if handle.finished:  # EOS or length inside the prefix
                    break
        if accepted_total:
            self.metrics.inc("finchat_spec_tokens_accepted_total", accepted_total)
        if spec_consulted:
            # the all-miss demotion keeps its cadence: a round where every
            # proposal missed or nothing was accepted advances the streak
            self._spec_note_step(accepted=accepted_total)
        # the fused tail: each loop slot's [loop_depth - 1] column, -1 where
        # the device's stop mask took over after an EOS
        self._drain_tail(block, loop_members)
        self.metrics.set_gauge("finchat_batch_occupancy", len(self.decoding))

    def _drain_tail(self, block: np.ndarray, members) -> None:
        """Deliver each member slot's column of a ``[K, max_seqs]`` token
        block until EOS or its length finishes the sequence, or a -1 marks
        where the device's stop mask took over. Iterations the device ran
        past a finished slot are counted as wasted tail tokens."""
        K = block.shape[0]
        wasted = 0
        for slot, handle, epoch in members:
            if handle.finished or handle.slot != slot or handle.epoch != epoch:
                wasted += K  # finished, cancelled or preempted since dispatch
                continue
            for j in range(K):
                token = int(block[j, slot])
                if token < 0:  # the device's stop mask
                    wasted += K - j
                    break
                self._deliver(handle, token)
                if handle.finished:  # EOS (host view) / length / cancel
                    wasted += K - j - 1
                    break
        if wasted:
            self.metrics.inc("finchat_decode_loop_wasted_tail_tokens_total", wasted)

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
        if handle.ngram_index is not None:
            handle.ngram_index.push(token_id)
        self.metrics.inc("finchat_tokens_generated_total")
        if token_id == self.eos_id:
            self._evict(handle, "eos")
        elif handle.generated >= handle.sampling.max_new_tokens:
            handle.events.put_nowait({"type": "token", "token_id": token_id})
            self._evict(handle, "length")
        else:
            handle.events.put_nowait({"type": "token", "token_id": token_id})

    def _dispatch_decode(self, exclude: set[int] | frozenset = frozenset(),
                         membership: list[tuple[int, SequenceHandle, int]] | None = None,
                         ) -> _InFlightStep:
        """Enqueue one decode step on the device without syncing. Slots in
        ``exclude`` (constrained slots whose pick is still pending) sit it
        out: inactive, their pages read and not written, their context and
        last token unchanged. ``membership`` pins the step to a given
        ``(slot, handle, epoch)`` snapshot instead of ``self.decoding`` (the
        demoted slots of a decode-loop iteration). The step's logits come
        back only while a constrained slot is in it, and only that slot's
        rows: ``[n, vocab]``, selected on the device, not the batch's
        ``[max_seqs, vocab]``."""
        inject("scheduler.decode", replica=self.replica_id)
        eng = self.engine
        B = eng.engine_cfg.max_seqs
        if membership is None:
            membership = [(slot, h, h.epoch) for slot, h in self.decoding.items()]
        active = np.zeros((B,), bool)
        members = []
        for slot, handle, epoch in membership:
            if slot in exclude:
                continue
            active[slot] = True
            members.append((slot, handle, epoch))
            handle.kv_ctx += 1
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

    def _undelivered(self, inflight) -> dict[int, int]:
        """Tokens a slot has in the still-unconsumed in-flight dispatch:
        ``handle.generated`` lags by exactly this at the next dispatch
        (depth 2 dispatches N+1 before consuming N), so budget checks
        subtract it; else a slot with K tokens left would ride two blocks
        and the second one's writes would run past its page allocation."""
        if inflight is None:
            return {}
        if isinstance(inflight, _InFlightRing):
            return dict(inflight.ahead)
        if isinstance(inflight, _InFlightBlock):
            ahead = {slot: self.loop_depth for slot, _h, _e in inflight.block_members}
            if inflight.step is not None:
                for slot, _h, _e in inflight.step.members:
                    ahead[slot] = 1
            return ahead
        return {slot: 1 for slot, _h, _e in inflight.members}

    def _loop_eligible(self, handle: SequenceHandle, ahead: int = 0) -> bool:
        """Can this slot ride a fused K-token block? It needs no per-token
        host control for the next ``loop_depth`` tokens: no grammar
        constraint, and at least K tokens of ``max_new_tokens`` left beyond
        the ``ahead`` tokens undelivered in the in-flight dispatch (its
        pages cover prompt + max_new, so this also bounds the block's
        writes). A bounded row's block must also stay inside its next
        eviction boundary (``_bounded_span_room``). A slot that fails is
        demoted to the single step riding the same iteration and rejoins
        blocks when it qualifies again (after the wave, for a bounded
        row)."""
        return (handle.constraint is None
                and handle.sampling.max_new_tokens - handle.generated - ahead
                >= self.loop_depth
                and self._bounded_span_room(handle) >= self.loop_depth)

    def _dispatch_decode_loop(self, exclude: set[int] | frozenset = frozenset(),
                              ahead: dict[int, int] | None = None) -> _InFlightBlock:
        """Enqueue one fused K-token decode block (plus one decode step for
        the demoted slots) without syncing; the caller guarantees at least
        one loop-eligible slot outside ``exclude``. ``exclude`` slots
        (constrained picks still pending) sit both out; ``ahead`` is
        ``_undelivered()`` of the in-flight dispatch.

        ONE membership snapshot drives both dispatches: the demoted step is
        built from the same ``(slot, handle, epoch)`` view as the block,
        never re-read from ``self.decoding``, so a slot vacated and filled
        again between the two dispatches cannot be stepped twice."""
        inject("scheduler.decode", replica=self.replica_id)
        eng = self.engine
        ahead = ahead or {}
        B = eng.engine_cfg.max_seqs
        membership = [(slot, h, h.epoch) for slot, h in self.decoding.items()]
        active = np.zeros((B,), bool)
        block_members = []
        demoted: list[tuple[int, SequenceHandle, int]] = []
        for slot, handle, epoch in membership:
            if slot in exclude:
                continue
            if self._loop_eligible(handle, ahead.get(slot, 0)):
                active[slot] = True
                block_members.append((slot, handle, epoch))
                handle.kv_ctx += self.loop_depth
            else:
                demoted.append((slot, handle, epoch))
        block = eng.decode_loop(active, self._temperature, self._top_p, self._top_k,
                                eos_id=self.eos_id)
        self._tally_dispatch()
        if TRACER.enabled:
            self._trace_dispatch("decode_loop", [[slot, h.trace_id or h.seq_id, "decode_loop"]
                                                 for slot, h, _e in block_members])
        self.metrics.inc("finchat_decode_loop_blocks_total")
        self.metrics.set_gauge("finchat_decode_loop_demoted_slots", len(demoted))
        step = self._dispatch_decode(membership=demoted) if demoted else None
        return _InFlightBlock(block_tokens=block, block_members=block_members, step=step)

    async def _consume_block(self, blk: _InFlightBlock) -> None:
        """Fetch a block's ``[K, max_seqs]`` tokens (one round trip for K
        steps) and drain each member's column (``_drain_tail``), then
        consume the demoted step."""
        eng = self.engine
        block = await asyncio.to_thread(lambda: eng.to_host(blk.block_tokens))
        self._drain_tail(block, blk.block_members)
        if blk.step is not None:
            await self._consume_step(blk.step)
        self.metrics.set_gauge("finchat_batch_occupancy", len(self.decoding))

    # --- speculative decode ---------------------------------------------
    @staticmethod
    def _spec_eligible(handle: SequenceHandle) -> bool:
        """Can drafts help this slot? Greedy, unconstrained, at least 2
        tokens to go (a draft needs room for itself and the bonus token)."""
        return (handle.constraint is None and handle.sampling.temperature <= 0.0
                and handle.sampling.max_new_tokens - handle.generated >= 2)

    def _spec_candidates(self) -> bool:
        """Can at least one decoding slot use a verify step? Otherwise the
        pipelined path is strictly better."""
        return any(self._spec_eligible(h) for h in self.decoding.values())

    def _propose(self, handle: SequenceHandle) -> list[int]:
        """A spec-eligible slot's drafts: up to ``spec_tokens``, at most its
        budget less the bonus token, and for a bounded row few enough that
        the (1 + drafts) verify span fits its eviction-boundary room
        (``_bounded_span_room``, taken before the dispatch's bump), from its
        n-gram index (built here once; ``_deliver`` keeps it in step)."""
        if handle.ngram_index is None:
            handle.ngram_index = NgramIndex(handle.history)
        cap = min(self.spec_k, handle.sampling.max_new_tokens - handle.generated - 1,
                  self._bounded_span_room(handle) - 1)
        return handle.ngram_index.propose(cap) if cap > 0 else []

    def _spec_proposal_live(self) -> bool:
        """Would the spec path propose drafts this round? Eligibility alone
        is no live proposal: a slot whose lookup misses runs a plain decode
        round anyway, so a free-run capture must not be cut for it."""
        return any(self._spec_eligible(h) and self._propose(h)
                   for h in self.decoding.values())

    def _spec_note_step(self, *, accepted: int) -> None:
        """The zero-accept streak behind spec's demotion: ``SPEC_MISS_DEMOTE``
        consecutive steps with nothing accepted put the loop back on the
        pipelined path for ``SPEC_RETRY_EVERY`` steps."""
        if accepted > 0:
            self._spec_miss_streak = 0
            return
        self._spec_miss_streak += 1
        if self._spec_miss_streak >= self.SPEC_MISS_DEMOTE:
            self._spec_miss_streak = 0
            self._spec_cooldown = self.SPEC_RETRY_EVERY
            self.metrics.inc("finchat_spec_demotions_total")

    async def _run_spec_step(self) -> None:
        """One speculative verify step: drafts from each greedy slot's
        n-gram index, every draft scored in one forward, the accepted prefix
        and the bonus token delivered a slot. Depth-1 (the drafts extend the
        last delivered token); a constrained slot rides draft-free and gets
        its host pick. When every lookup misses, the plain decode step runs
        instead (a (Kd+1)-wide forward would emit one token a slot)."""
        if not self.decoding:
            return  # consuming the drained pipeline step may have evicted all
        inject("scheduler.decode", replica=self.replica_id)
        eng = self.engine
        B = eng.engine_cfg.max_seqs
        Kd = self.spec_k
        active = np.zeros((B,), bool)
        drafts = np.zeros((B, Kd), np.int32)
        n_drafts = np.zeros((B,), np.int32)
        members = []
        for slot, handle in self.decoding.items():
            active[slot] = True
            members.append((slot, handle, handle.epoch))
            if self._spec_eligible(handle):
                prop = self._propose(handle)
                drafts[slot, : len(prop)] = prop
                n_drafts[slot] = len(prop)
        if not n_drafts.any():
            # the plain step instead, which books its own kv_ctx advance
            self._spec_note_step(accepted=0)
            await self._consume_step(self._dispatch_decode())
            return
        for _slot, handle, _epoch in members:
            handle.kv_ctx += 1  # the verify's position-0 write
        constrained_slots = sorted(slot for slot, h, _e in members if h.constraint is not None)
        logits = None
        if constrained_slots:
            emitted, n_emitted, logits = eng.decode_spec(
                active, drafts, n_drafts, self._temperature, self._top_p, self._top_k,
                return_logits=True)
            logits = eng.select_rows(logits, constrained_slots)
        else:
            emitted, n_emitted = eng.decode_spec(active, drafts, n_drafts, self._temperature,
                                                 self._top_p, self._top_k)
        self._tally_dispatch()
        if TRACER.enabled:
            self._trace_dispatch("spec", [[slot, h.trace_id or h.seq_id, "spec"]
                                          for slot, h, _e in members])
        emitted_host, n_host, logits_host = await asyncio.to_thread(
            lambda: (eng.to_host(emitted), eng.to_host(n_emitted),
                     eng.to_host(logits) if logits is not None else None))
        accepted_total = 0
        for slot, handle, epoch in members:
            if handle.finished or handle.slot != slot or handle.epoch != epoch:
                continue  # evicted, cancelled or preempted since dispatch
            if handle.constraint is not None and logits_host is not None:
                self._deliver(handle, self._constrained_pick(
                    handle, logits_host[constrained_slots.index(slot)]))
                continue
            n = int(n_host[slot])
            handle.kv_ctx += max(0, n - 1)  # the accepted drafts' context advance
            accepted_total += max(0, n - 1)
            for token in emitted_host[slot, :n]:
                self._deliver(handle, int(token))
                if handle.finished:  # EOS or length inside the prefix
                    break
        if accepted_total:
            self.metrics.inc("finchat_spec_tokens_accepted_total", accepted_total)
        self._spec_note_step(accepted=accepted_total)
        self.metrics.set_gauge("finchat_batch_occupancy", len(self.decoding))

    # --- the free-running loop --------------------------------------------
    def _freerun_rounds_cap(self) -> int:
        """How many rounds the next capture may run. Rows that need a host
        decision every round cut it to 1, the host-stepped round:
        constrained rows (the pick feeds the next round's input) and live
        spec proposals (drafts come from delivered tokens the device still
        holds). A bounded row caps it at its next eviction boundary, so a
        capture sees the host-stepped gap schedule."""
        F = self.freerun_rounds
        if F <= 1:
            return 1
        if (any(h.constraint is not None for h in self.decoding.values())
                or any(h.constraint is not None for h in self.prefilling
                       if not self._parked(h))):
            self.metrics.inc("finchat_freerun_capped_total", labels={"reason": "constrained"})
            return 1
        if self.spec_k > 0 and self._spec_cooldown == 0 and self._spec_proposal_live():
            self.metrics.inc("finchat_freerun_capped_total", labels={"reason": "spec"})
            return 1
        if self.bounded_kv is not None:
            # eviction is staged at capture boundaries, like budget stops
            cap = self._bounded_freerun_cap()
            if cap < F:
                self.metrics.inc("finchat_freerun_capped_total", labels={"reason": "boundedkv"})
                return max(1, cap)
        return F

    def _dispatch_freerun(self, rounds: int,
                          ahead: dict[int, int]) -> _InFlightRing | None:
        """Stage and enqueue ONE captured multi-round dispatch: every
        prefilling row's next ``rounds`` chunks, every decode slot's next
        ``rounds`` tokens (with fused tails where they fit) and the
        completion-to-decode flips between them go into the descriptor
        queue (``ops/freerun.stage_freerun``), and the device runs the
        rounds with no host round trip. Returns None (the caller runs the
        host-stepped round) when the work runs out before the capture
        would. ``ahead`` is ``_undelivered()`` of the unconsumed in-flight
        dispatch: budgets are staged net of it."""
        eng = self.engine
        C = eng.engine_cfg.prefill_chunk
        B = eng.engine_cfg.max_seqs
        specs: list[RowSpec] = []
        members: list[tuple] = []
        loop_ok = self.loop_depth > 1

        def budget(h: SequenceHandle) -> int:
            return max(0, h.sampling.max_new_tokens - h.generated - ahead.get(h.slot, 0))

        def decode_spec(h: SequenceHandle) -> RowSpec:
            s = h.sampling
            return RowSpec(slot=h.slot, kind="decode", budget=budget(h), loop_ok=loop_ok,
                           temperature=s.temperature, top_p=s.top_p, top_k=s.top_k)

        for handle in self._prefill_batch():
            if handle.prefill_pos >= len(handle.prompt_ids):
                # completed inside a still-unconsumed ring: its first token
                # is in flight (counted in ``ahead``), a decode row here
                specs.append(decode_spec(handle))
                members.append((len(specs) - 1, handle.slot, handle, handle.epoch, "decode"))
                continue
            s = handle.sampling
            specs.append(RowSpec(slot=handle.slot, kind="prefill", ids=handle.prompt_ids,
                                 pos=handle.prefill_pos, arm=not handle.held,
                                 budget=budget(handle), loop_ok=loop_ok,
                                 temperature=s.temperature, top_p=s.top_p, top_k=s.top_k))
            members.append((len(specs) - 1, handle.slot, handle, handle.epoch, "prefill"))
        for job in list(self._prefix_jobs):
            specs.append(RowSpec(slot=job.slot, kind="job", ids=job.ids[: job.shared_len],
                                 pos=job.pos, arm=False))
            members.append((len(specs) - 1, job.slot, job, 0, "job"))
        for slot, handle in self.decoding.items():
            specs.append(decode_spec(handle))
            members.append((len(specs) - 1, slot, handle, handle.epoch, "decode"))
        if not specs:
            return None  # a fault drained everything; the split paths go on
        plan = stage_freerun(specs, rounds=rounds, chunk=C, loop_depth=self.loop_depth,
                             max_seqs=B, bucket=eng.ragged_bucket)
        if plan.active_rounds < rounds:
            # the work runs out before the capture would: run the
            # host-stepped round rather than empty device rounds
            self.metrics.inc("finchat_freerun_capped_total", labels={"reason": "underfill"})
            return None
        inject("scheduler.decode", replica=self.replica_id)
        inject("scheduler.mixed", replica=self.replica_id)
        with Timer(self.metrics, "finchat_mixed_step_seconds") as mt:
            ring_tok, ring_n, ring_blk = eng.ragged_multi(
                plan.tokens, plan.tok_row, plan.row_slot, plan.row_start, plan.row_len,
                plan.row_from_device, plan.row_arm, plan.temperature, plan.top_p, plan.top_k,
                plan.loop_active, self._temperature, self._top_p, self._top_k, self.eos_id)
        self._tally_dispatch()
        self._round_tally += rounds
        self.metrics.inc("finchat_freerun_dispatches_total")
        # the unit is rounds: rounds a dispatch
        self.metrics.observe("finchat_freerun_rounds_per_dispatch", rounds)
        if TRACER.enabled:
            trows = [[slot, f"prefix:{owner.owner}" if kind == "job"
                      else (owner.trace_id or owner.seq_id), "freerun"]
                     for _row, slot, owner, _epoch, kind in members]
            self._trace_dispatch("freerun", trows, ts=mt.started, dur=mt.elapsed)
        # the prompt cursors advance at dispatch, as in the ragged round:
        # the staged chunks are dispatched
        for row, slot, owner, _epoch, kind in members:
            adv = plan.advanced.get(row, 0)
            if kind == "job":
                if adv:
                    owner.pos += adv
                    if owner.pos >= owner.shared_len:
                        self._complete_prefix_job(owner, "freerun")
                continue
            if adv:
                owner.prefill_pos += adv
                owner.kv_ctx = owner.prefill_pos
            # the staged decode rounds advance the context a token an armed
            # round, and the fused tails theirs: plan.ahead counts exactly
            # those emissions, less a completion's first token (sampled,
            # its KV not yet written)
            extra = plan.ahead.get(slot, 0)
            if row in plan.completes_at:
                extra -= 1
            owner.kv_ctx += max(0, extra)
        return _InFlightRing(tokens=ring_tok, n_emitted=ring_n, blocks=ring_blk, rounds=rounds,
                             members=members, armed=plan.row_arm, loop_rounds=plan.loop_active,
                             completes_at=plan.completes_at, ahead=plan.ahead)

    async def _consume_ring(self, ring: _InFlightRing) -> None:
        """Drain a captured run's token ring: ONE fetch (in a worker thread)
        for up to ``rounds`` tokens a row plus the fused tails, delivered
        round by round in device order, while the device may already run
        the next capture. Stale rows (evicted, preempted or replayed since
        the dispatch, told by the ``(slot, handle, epoch)`` snapshot) have
        their ring tokens dropped exactly once, the replay recomputing
        them: the epoch boundary, a ``freerun_epoch_break`` trace event. A
        round emitting where the staged plan armed nothing is a free-run
        divergence: the flight recorder dumps, those cells deliver
        nothing."""
        eng = self.engine
        tok_host, n_host, blk_host = await asyncio.to_thread(
            lambda: (eng.to_host(ring.tokens), eng.to_host(ring.n_emitted),
                     eng.to_host(ring.blocks)))
        armed = ring.armed
        stray = (n_host > 0) & ~armed
        if stray.any():
            self.metrics.inc("finchat_freerun_divergences_total")
            TRACER.anomaly("freerun_divergence", args={"rounds": ring.rounds,
                                                       "cells": int(stray.sum())})
        K1 = int(blk_host.shape[1])
        wasted = 0
        epoch_break = False
        for r in range(ring.rounds):
            for row, slot, owner, epoch, kind in ring.members:
                if kind == "job":
                    continue
                handle: SequenceHandle = owner
                stale = handle.finished or handle.slot != slot or handle.epoch != epoch
                n = int(n_host[r, row])
                if n > 0 and armed[r, row]:
                    if stale:
                        # the replay recomputes this token: dropping it here
                        # keeps delivery exactly-once
                        epoch_break = True
                        wasted += n
                    else:
                        if ring.completes_at.get(row) == r:
                            handle.span.mark("prefill_done")
                            self.prefilling.remove(handle)
                            self.decoding[handle.slot] = handle
                        self._deliver(handle, int(tok_host[r, row]))
                        stale = handle.finished or handle.slot != slot or handle.epoch != epoch
                if K1 and ring.loop_rounds[r, slot]:
                    if stale:
                        wasted += K1
                        continue
                    for j in range(K1):
                        token = int(blk_host[r, j, slot])
                        if token < 0:  # the device's stop mask
                            wasted += K1 - j
                            break
                        self._deliver(handle, token)
                        if handle.finished:
                            wasted += K1 - j - 1
                            break
        if wasted:
            self.metrics.inc("finchat_decode_loop_wasted_tail_tokens_total", wasted)
        if epoch_break:
            self.metrics.inc("finchat_freerun_epoch_breaks_total")
            TRACER.event("freerun_epoch_break", track=self._trace_track,
                         args={"rounds": ring.rounds})
        self.metrics.set_gauge("finchat_batch_occupancy", len(self.decoding))

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

    @staticmethod
    def _pending_constrained(inflight) -> set[int]:
        """Constrained slots whose host pick lands only when ``inflight`` is
        consumed: they sit out the next dispatch. In a block they ride only
        the demoted step; a free-run capture never carries them."""
        if inflight is None or isinstance(inflight, _InFlightRing):
            return set()
        if isinstance(inflight, _InFlightBlock):
            return set(inflight.step.constrained_slots) if inflight.step else set()
        return set(inflight.constrained_slots)

    async def _consume_inflight(self, inflight) -> None:
        if isinstance(inflight, _InFlightRing):
            await self._consume_ring(inflight)
        elif isinstance(inflight, _InFlightBlock):
            await self._consume_block(inflight)
        else:
            await self._consume_step(inflight)

    async def _drain_inflight(self, inflight) -> None:
        """Consume an in-flight dispatch outside the decode try-block (idle
        drain, before a ragged round, before a preemption), turning a
        failure into the whole-round path. A failed consume is never
        retried: the replay recomputes what was not delivered. Returns None
        (the caller's new ``inflight``)."""
        ring = isinstance(inflight, _InFlightRing)
        try:
            await self._consume_inflight(inflight)
            self._note_round_ok("decode")
            if ring:  # a capture carried the prefill rows too
                self._note_round_ok("prefill")
        except Exception as e:
            logger.error("in-flight step consume error: %s", e)
            await self._round_failed("mixed" if ring else "decode", str(e))
        return None

    async def _loop(self) -> None:
        logger.info("scheduler loop started (max_seqs=%d, quant=%s)",
                    self.engine.engine_cfg.max_seqs, self.quant_label)
        inflight: _InFlightStep | _InFlightBlock | _InFlightRing | None = None
        while self._running:
            self._reap_stale_holds()
            if self._coexist_mark is not None:
                self.metrics.inc("finchat_coexist_dispatches_total",
                                 self._dispatch_tally - self._coexist_mark)
                # and the serving rounds they advanced (a capture books F
                # rounds for its one dispatch): their ratio is dispatches a
                # round
                self.metrics.inc("finchat_coexist_rounds_total",
                                 self._round_tally - self._coexist_round_mark)
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
                # only once the dispatch in flight is drained, so no freed
                # page is still the target of a queued write
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
                # the bounded eviction wave runs between dispatches: its table
                # and gap writes enqueue after every dispatch in flight and
                # before this iteration's, so stream order keeps each dispatch
                # reading the table it was built against, and the freed
                # pages' next writers come after it
                self._bounded_evict_wave()
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
                self._coexist_round_mark = self._round_tally

            if self._spec_cooldown > 0:
                # demoted after all-miss steps: count down to the next probe
                self._spec_cooldown -= 1

            if self._use_mixed():
                rounds = self._freerun_rounds_cap()
                if rounds > 1:
                    # the free-running loop, depth 2: stage and dispatch the
                    # next capture FIRST, then drain the previous dispatch
                    # while the device runs it. A membership change between
                    # (admit, evict, preempt, a trip) ends re-entry at this
                    # round boundary; stale ring tokens replay exactly once
                    ring = None
                    try:
                        ring = self._dispatch_freerun(rounds, self._undelivered(inflight))
                    except Exception as e:
                        logger.error("freerun dispatch error: %s", e)
                        if inflight is not None:
                            inflight = await self._drain_inflight(inflight)
                        await self._round_failed("mixed", str(e))
                        await asyncio.sleep(0)
                        continue
                    if ring is not None:
                        prev, inflight = inflight, ring
                        if prev is not None:
                            await self._drain_inflight(prev)
                        await asyncio.sleep(0)
                        continue
                    # the staging underfilled: the host-stepped round below
                # the host-stepped ragged round is depth-1 (dispatch and
                # consume within the iteration): drain any pipelined
                # dispatch first, which also lands its pending picks
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

            if isinstance(inflight, _InFlightRing):
                # leaving the ragged path with a capture in flight: drain it
                # before any split round. A prompt that completed inside the
                # capture is still in ``prefilling`` until the drain moves
                # it to decoding; a split prefill round run first would
                # complete it again on an empty chunk
                inflight = await self._drain_inflight(inflight)

            if self._prefill_work():
                try:
                    await self._prefill_round()
                    self._note_round_ok("prefill")
                except Exception as e:
                    logger.error("prefill round error: %s", e)
                    await self._round_failed("prefill", str(e))
                try:
                    # a completion joins THIS iteration's decode dispatch
                    # below: its first decode write needs the wave's room at
                    # the advanced kv_ctx (a no-op when no boundary was
                    # crossed)
                    self._bounded_evict_wave()
                except Exception as e:
                    logger.error("bounded eviction wave error: %s", e)

            if (self.decoding and self.spec_k > 0 and self._spec_cooldown == 0
                    and self._spec_candidates()):
                try:
                    # speculative decode is depth-1: drain the pipelined
                    # dispatch left over from the depth-2 path first
                    if inflight is not None:
                        await self._consume_inflight(inflight)
                        inflight = None
                    await self._run_spec_step()
                    self._note_round_ok("decode")
                except Exception as e:
                    logger.error("spec decode step error: %s", e)
                    inflight = None
                    await self._round_failed("spec", str(e))
            elif self.decoding:
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
                    pending = self._pending_constrained(inflight)
                    ahead = self._undelivered(inflight)
                    use_loop = self.loop_depth > 1 and any(
                        slot not in pending and self._loop_eligible(h, ahead.get(slot, 0))
                        for slot, h in self.decoding.items())
                    if use_loop:
                        # depth-2 blocks: dispatch block N+1 (the demoted
                        # slots one step, pending constrained slots out),
                        # then consume N
                        blk = self._dispatch_decode_loop(exclude=pending, ahead=ahead)
                        if inflight is not None:
                            await self._consume_inflight(inflight)
                            consumed = True
                        inflight = blk
                    elif any(slot not in pending for slot in self.decoding):
                        # depth-2 pipeline: dispatch N+1, then consume N — the
                        # device computes while the host delivers tokens
                        step = self._dispatch_decode(exclude=pending)
                        if inflight is not None:
                            await self._consume_inflight(inflight)
                            consumed = True
                        inflight = step
                    else:
                        # every decoding slot waits on a pick: drain, then
                        # run depth-1
                        if inflight is not None:
                            await self._consume_inflight(inflight)
                            inflight = None
                            consumed = True
                        if self.decoding:
                            await self._consume_step(self._dispatch_decode())
                            consumed = True
                    if consumed:
                        self._note_round_ok("decode")
                except Exception as e:
                    # a whole-batch failure: every in-flight decode recovers
                    # together, and the dropped dispatch is never consumed again
                    logger.error("decode step error: %s", e)
                    inflight = None
                    await self._round_failed("decode", str(e))
            elif inflight is not None:
                inflight = await self._drain_inflight(inflight)

            await asyncio.sleep(0)  # let producers/consumers run
        # a dispatch still in flight is dropped, as in the reference: its
        # members are either finished or about to be failed by
        # shutdown_drain, whose offload covers what was delivered
        logger.info("scheduler loop stopped")
