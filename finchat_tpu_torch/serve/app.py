"""The serving app: the Kafka worker loop and the HTTP surface (own copy of
the JAX package's ``serve/app.py``, single engine).

- Lifespan: store connection check, consumer setup, scheduler start,
  consume task, prefix-cache refresh task, HTTP server.
- ``process_message``: the context and history fetch (an error drops the
  message), ``stream_with_status`` where only ``response_chunk``, ``plot``
  and ``complete`` events reach Kafka (``stream_flush_tokens`` chunks to a
  produce), the flushed error chunk on failure, then the answer persisted.
- The consume loop: one task per message, the same conversation's messages
  kept in order, at most ``max_seqs`` in flight, each under the
  ``watchdog_seconds`` watchdog (its timeout chunk after the generation is
  cancelled and cleaned up). With ``kafka.commit_after_process``, offsets
  commit at each partition's contiguous-completion watermark, a
  redelivered answered ``message_id`` is skipped (``DedupeRing``), and an
  answered id is journaled (io/journal.py) before its offset commits.
  Deadlines (``request_deadline_seconds``) are anchored at the producer
  timestamp; every message's trace starts with an ``ingress`` event keyed
  by its ``message_id``.
- HTTP: ``GET /health``, ``GET /metrics`` (Prometheus text),
  ``GET /debug/trace/<trace_id>`` (Chrome trace-event JSON), ``POST
  /chat`` (batch ``LLMAgent.query``), ``POST /chat/stream`` (server-sent
  events of the whole event protocol) and ``POST /transactions`` (and the
  ``transaction_upsert`` topic) for a retriever with
  ``upsert_transactions``.
- ``drain_and_stop``: the graceful shutdown. Admission stops, in-flight
  streams get ``shutdown.deadline_seconds`` to complete, the stragglers
  are preempted with a retryable ``shutting_down`` error, the session
  entries spill, and nothing is left on the pool.

``build_app`` assembles a worker from an ``AppConfig``. It refuses, with an
error that names the plane, what the port does not carry yet: a fleet
(``fleet.replicas`` > 1), the warm-state fabric, a pod, a mesh of more than
one device, a checkpoint or tokenizer path, and a missing ``retriever=``
(the embedding retriever is not ported yet). The engine runs on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
import uuid
from pathlib import Path

import torch

from finchat_tpu_torch.agent.graph import LLMAgent
from finchat_tpu_torch.engine.engine import InferenceEngine
from finchat_tpu_torch.engine.generator import EngineGenerator, StubGenerator, TextGenerator
from finchat_tpu_torch.engine.sampler import SamplingParams
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from finchat_tpu_torch.io.kafka import KafkaClient
from finchat_tpu_torch.io.schemas import (
    complete_chunk,
    error_chunk,
    plot_chunk,
    response_chunk,
    timeout_chunk,
)
from finchat_tpu_torch.io.store import ConversationStore, make_store
from finchat_tpu_torch.models.llama import PRESETS, init_params
from finchat_tpu_torch.models.quant import init_quantized_params
from finchat_tpu_torch.models.tokenizer import ByteTokenizer, get_tokenizer
from finchat_tpu_torch.serve.fleet import DedupeRing
from finchat_tpu_torch.serve.http import HTTPServer, Request, Response, StreamingResponse, sse_event
from finchat_tpu_torch.utils.config import (
    AI_RESPONSE_TOPIC,
    TRANSACTION_UPSERT_TOPIC,
    USER_MESSAGE_TOPIC,
    AppConfig,
    MeshConfig,
    load_config,
)
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS
from finchat_tpu_torch.utils.tracing import TRACER

logger = get_logger(__name__)

_PROMPTS_DIR = Path(__file__).resolve().parent.parent.parent / "prompts"

# ByteTokenizer's own width: 256 bytes and four specials
_BYTE_VOCAB = 260

_REPACE_DONE = object()


async def _repace_bursts(updates, loop_depth: int, burst_cap: int | None = None):
    """Spread the fused decode loop's K-token bursts over the observed block
    cadence for SSE clients. Every token stays its own SSE frame; a reader
    task timestamps arrivals before any pacing sleep, burst starts are found
    on that timeline, an EMA runs over burst-start deltas (the block period)
    and over burst widths (clamped to ``[1, burst_cap]``), and members are
    emitted about a block / width apart, never held past one block after
    their arrival nor paced more than 50 ms a token. With K <= 1 and no
    wider cap (the only depth the port's scheduler serves) it is a
    passthrough."""
    burst_cap = max(loop_depth, burst_cap or loop_depth)
    if burst_cap <= 1:
        async for update in updates:
            yield update
        return

    queue: asyncio.Queue = asyncio.Queue()

    async def _reader():
        try:
            async for update in updates:
                queue.put_nowait((time.monotonic(), update))
        except BaseException as e:  # propagate into the consumer
            queue.put_nowait((0.0, e))
            return
        queue.put_nowait((0.0, _REPACE_DONE))

    reader = asyncio.create_task(_reader())
    ema: float | None = None
    burst_start: float | None = None
    last_arrival: float | None = None
    next_emit = 0.0
    eff_width = float(max(1, loop_depth))
    burst_n = 0
    try:
        while True:
            t_arr, update = await queue.get()
            if update is _REPACE_DONE:
                return
            if isinstance(update, BaseException):
                raise update
            if update.get("type") != "response_chunk":
                yield update
                continue
            # a burst boundary: EMA-relative with a 10 ms floor, so loop
            # jitter between members of one block does not split the burst
            threshold = max(1e-2, ema / (2 * eff_width)) if ema else 1e-2
            if last_arrival is None or t_arr - last_arrival > threshold:
                if burst_start is not None:
                    delta = t_arr - burst_start
                    ema = delta if ema is None else 0.7 * ema + 0.3 * delta
                    eff_width = min(
                        max(0.7 * eff_width + 0.3 * max(burst_n, 1), 1.0),
                        float(burst_cap),
                    )
                burst_start = t_arr
                burst_n = 0
            burst_n += 1
            last_arrival = t_arr
            if ema:
                pace = min(ema / eff_width, 0.05)
                now = time.monotonic()
                target = min(max(now, next_emit), t_arr + ema)
                if target > now:
                    await asyncio.sleep(target - now)
                next_emit = target + pace
            yield update
    finally:
        reader.cancel()
        try:
            await reader
        except (asyncio.CancelledError, Exception):
            pass


def load_prompts() -> tuple[str, str]:
    system_prompt = (_PROMPTS_DIR / "system_prompt.txt").read_text()
    tool_prompt = (_PROMPTS_DIR / "tool_prompt.txt").read_text()
    return system_prompt, tool_prompt


def _encode_head(tokenizer, head: str) -> list[int]:
    """Encode a shared prompt head for prefix registration: BOS added, the
    last token dropped (a subword tokenizer can merge across the head's end,
    so that token is the only one whose identity depends on what follows).
    Startup registration and the refresh both encode through here, so a
    refreshed head keeps matching."""
    return tokenizer.encode(head, add_bos=True)[:-1]


def register_prompt_prefixes(agent, scheduler, tokenizer) -> set[str]:
    """Prefill each LLM role's constant system head once and share its KV
    across requests. Returns the heads that registered, each on its own, so
    one head that cannot register does not keep the other out."""
    registered: set[str] = set()
    for head in agent.prompt_heads():
        if scheduler.register_prefix(_encode_head(tokenizer, head)) > 0:
            registered.add(head)
    return registered


async def _maybe_refresh_prefix_cache(app: "App") -> None:
    """Re-register the shared prompt heads when they changed (they carry
    today's date, so they go stale at midnight) or were dropped by an engine
    rebuild: retire the stale heads (their pages free once the last
    reference goes) and register the missing ones through the scheduler's
    chunked path, so in-flight streams keep decoding between head chunks."""
    if not app._prefix_cache_enabled or app.scheduler is None:
        return
    heads = app.agent.prompt_heads()
    if all(h in app._registered_heads for h in heads):
        return
    tokenizer = getattr(app.agent.tool_generator, "tokenizer", None)
    if tokenizer is None:
        return
    stale = [h for h in app._registered_heads if h not in heads]
    if stale:
        logger.info("prompt heads changed (date rollover); refreshing prefix cache")
        app.scheduler.retire_prefixes()
        app._registered_heads = set()
    for head in heads:
        if head in app._registered_heads:
            continue
        if await app.scheduler.register_prefix_async(_encode_head(tokenizer, head)) > 0:
            app._registered_heads.add(head)


async def _prefix_refresh_loop(app: "App") -> None:
    """Check the shared heads every ``_prefix_refresh_check_s``; the check is
    a few string comparisons, a registration at most once a day."""
    while app._running:
        try:
            await _maybe_refresh_prefix_cache(app)
        except Exception as e:  # best-effort: the cache is an optimization
            logger.error("prefix cache refresh error: %s", e)
        await asyncio.sleep(app._prefix_refresh_check_s)


def _mesh_devices(mesh: MeshConfig, n_available: int) -> int:
    """How many devices the mesh config resolves to: a -1 axis absorbs
    every device, a fully fixed mesh uses its own product."""
    sizes = (mesh.data, mesh.pipe, mesh.seq, mesh.expert, mesh.model)
    if -1 in sizes:
        return n_available
    n = 1
    for s in sizes:
        n *= s
    return n


def _load_model_artifacts(cfg: AppConfig, device: str | torch.device = "cuda") -> tuple:
    """(model config, params, tokenizer, device): random weights from a
    ``torch.Generator`` seeded with ``model.seed``, made on the device
    (int8/int4 leaves quantized as they are made with ``model.quant``, so
    the full-precision tree never exists). Where no tokenizer path is given
    and the model's rows are wider than the byte tokenizer's 260 ids, the
    tokenizer is a ``ByteTokenizer`` as wide as the rows (its ids past 255
    decode to nothing), so the decision's grammar masks are as wide as the
    logits they mask."""
    device = torch.device(device)
    n_available = torch.cuda.device_count() if device.type == "cuda" else 1
    n_mesh = _mesh_devices(cfg.mesh, n_available)
    if n_mesh > 1:
        raise NotImplementedError(
            f"mesh: the config resolves to {n_mesh} devices; the parallel plane is not "
            "ported yet (set every mesh axis to 1, or leave model=-1 on one card)")
    config = PRESETS[cfg.model.preset]
    if cfg.model.dtype:
        config = dataclasses.replace(config, dtype=getattr(torch, cfg.model.dtype))
    if not cfg.model.tokenizer_path and config.vocab_size > _BYTE_VOCAB:
        tokenizer = ByteTokenizer(vocab_size=config.vocab_size)
    else:
        tokenizer = get_tokenizer(cfg.model.tokenizer_path)
    logger.warning("no checkpoint configured; using RANDOM weights (preset=%s)",
                   cfg.model.preset)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.model.seed)
    if cfg.model.quant:
        params = init_quantized_params(config, gen, device, mode=cfg.model.quant,
                                       group_size=cfg.model.quant_group)
    else:
        params = init_params(config, gen, device)
    return config, params, tokenizer, device


def make_engine_replica(cfg: AppConfig, artifacts: tuple
                        ) -> tuple[EngineGenerator, ContinuousBatchingScheduler]:
    """The engine over the artifacts: its KV page pool, scheduler and session
    cache, warmed up first when ``engine.warmup_on_start`` is set."""
    config, params, tokenizer, device = artifacts
    engine = InferenceEngine(config, params, cfg.engine, device=device,
                             quant=cfg.model.quant, quant_group=cfg.model.quant_group)
    if cfg.engine.warmup_on_start:
        engine.warmup()
    scheduler = ContinuousBatchingScheduler(engine, eos_id=tokenizer.eos_id)
    return EngineGenerator(scheduler, tokenizer), scheduler


def build_generators(cfg: AppConfig, device: str | torch.device = "cuda"
                     ) -> tuple[TextGenerator, TextGenerator,
                                ContinuousBatchingScheduler | None, object]:
    """(tool_generator, response_generator, scheduler, tokenizer):
    ``model.preset == "stub"`` gives canned generators and no engine;
    anything else one engine whose scheduler serves both agent roles."""
    if cfg.model.preset == "stub":
        stub = StubGenerator(default="I'm Penny, here to help with your finances.")
        return stub, stub, None, get_tokenizer()
    artifacts = _load_model_artifacts(cfg, device)
    generator, scheduler = make_engine_replica(cfg, artifacts)
    return generator, generator, scheduler, artifacts[2]


class App:
    """One worker process: HTTP surface, Kafka consume loop and engine."""

    def __init__(self, cfg: AppConfig, *, agent: LLMAgent, store: ConversationStore,
                 kafka: KafkaClient, scheduler: ContinuousBatchingScheduler | None = None,
                 retriever=None):
        self.cfg = cfg
        self.agent = agent
        self.store = store
        self.kafka = kafka
        self.scheduler = scheduler
        # the reference's fleet and pod planes; not ported, always None
        self.fleet = None
        self.pod = None
        self.retriever = retriever
        self.server = HTTPServer(cfg.serve.host, cfg.serve.port)
        self.server.route("GET", "/health", self.health)
        self.server.route("GET", "/metrics", self.metrics)
        self.server.route_prefix("GET", "/debug/trace/", self.debug_trace)
        self.server.route("POST", "/chat", self.chat)
        self.server.route("POST", "/chat/stream", self.chat_stream)
        self.server.route("POST", "/transactions", self.upsert_transactions)
        self._consume_task: asyncio.Task | None = None
        self._running = False
        # one task per in-flight message, so many conversations batch onto
        # the engine together, and a per-conversation chain that keeps one
        # conversation's messages serial
        self._inflight: set[asyncio.Task] = set()
        self._conv_tails: dict[str, asyncio.Task] = {}
        # the shared heads carry today's date: build_app fills this with
        # the heads that registered, the refresh loop keeps it current
        self._prefix_cache_enabled = cfg.engine.prefix_cache and scheduler is not None
        self._registered_heads: set[str] = set()
        self._prefix_refresh_check_s = 60.0
        self._prefix_refresh_task: asyncio.Task | None = None
        # at-least-once (kafka.commit_after_process): offsets commit only at
        # each partition's contiguous-completion watermark (a bare offset
        # would commit every earlier message still in flight), and a bounded
        # ring of answered ids keeps a redelivery from being answered twice
        self._commit_enabled = cfg.kafka.commit_after_process
        self._done_offsets: dict[tuple[str, int], set[int]] = {}
        self._commit_next: dict[tuple[str, int], int] = {}
        self._dedupe = DedupeRing()
        # answered ids are fsynced here before their offsets commit, and a
        # restart replays them into the ring; failed ids are never journaled
        self._journal = None
        if cfg.journal.path:
            from finchat_tpu_torch.io.journal import AnsweredJournal

            try:
                self._journal = AnsweredJournal(
                    cfg.journal.path, fsync=cfg.journal.fsync,
                    keep=self._dedupe.size,
                    num_partitions=getattr(kafka, "num_partitions", 1),
                )
                self._dedupe.preload(self._journal.replay())
            except Exception as e:  # durability is best-effort
                logger.error("answered journal unavailable at %s: %s",
                             cfg.journal.path, e)
                self._journal = None
        # set while drain_and_stop runs: the HTTP chat paths answer a
        # retryable 503
        self._draining = False

    # --- lifespan -------------------------------------------------------
    async def start(self, serve_http: bool = True) -> None:
        await self.store.check_connection()
        topics = [USER_MESSAGE_TOPIC]
        if self.retriever is not None:
            topics.append(TRANSACTION_UPSERT_TOPIC)
        self.kafka.setup_consumer(topics=topics)
        if self.scheduler is not None:
            if self._on_engine_rebuild not in self.scheduler.on_rebuild:
                self.scheduler.on_rebuild.append(self._on_engine_rebuild)
            await self.scheduler.start()
        self._running = True
        self._consume_task = asyncio.create_task(self.consume_messages())
        if self._prefix_cache_enabled:
            self._prefix_refresh_task = asyncio.create_task(_prefix_refresh_loop(self))
        if serve_http:
            await self.server.start()

    async def stop(self) -> None:
        self._running = False
        for task in (self._prefix_refresh_task, self._consume_task):
            if task:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        for task in list(self._inflight):  # in-flight conversations
            task.cancel()
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        if self.scheduler is not None:
            await self.scheduler.stop()
        await self.server.stop()
        self.kafka.close()
        if self._journal is not None:
            self._journal.close()

    async def drain_and_stop(self) -> None:
        """Graceful shutdown: stop admission (polling halts, HTTP chat
        answers a retryable 503), let in-flight streams complete within
        ``shutdown.deadline_seconds`` (their answers journal and their
        offsets commit as in steady state), then preempt the stragglers:
        each one's KV spills through the session disk tier and its client
        gets a retryable ``shutting_down`` error. Every session entry
        spills, and the scheduler exits with no slot or page left."""
        t0 = time.perf_counter()
        METRICS.inc("finchat_durability_graceful_drains_total")
        # the flight recorder's black box of what was in flight
        TRACER.anomaly("sigterm_drain", args={"inflight": len(self._inflight)})
        self._draining = True
        self._running = False
        if self._consume_task:
            self._consume_task.cancel()
            try:
                await self._consume_task
            except asyncio.CancelledError:
                pass
            self._consume_task = None
        deadline = max(0.0, self.cfg.shutdown.deadline_seconds)
        if self._inflight:
            _done, stragglers = await asyncio.wait(set(self._inflight), timeout=deadline)
            if stragglers:
                logger.warning(
                    "graceful drain: %d in-flight message(s) past the %.1fs deadline; "
                    "preempting to host", len(stragglers), deadline,
                )
        # the stragglers' handles fail with the retryable shutting_down
        # error and their KV spills; the loop stops first, so no dispatch
        # races the offload
        if self.scheduler is not None:
            try:
                await self.scheduler.shutdown_drain()
            except Exception as e:
                logger.error("scheduler shutdown drain failed: %s", e)
        # the straggler tasks emit their error chunks and commit their offsets
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        METRICS.observe("finchat_durability_shutdown_drain_seconds", time.perf_counter() - t0)
        # flight dumps are written by threads: join them off the loop
        await asyncio.to_thread(TRACER.flush_dumps)
        await self.stop()

    def _on_engine_rebuild(self) -> None:
        """A breaker trip rebuilt the engine's device state and the heads'
        prefilled KV went with it: mark them unregistered, so the refresh
        loop registers them again through the chunked path."""
        self._registered_heads = set()

    def _request_deadline(self, wall_anchor_s: float | None = None) -> float | None:
        """The request's deadline on ``time.perf_counter``'s clock, or None
        when ``engine.request_deadline_seconds`` is 0. Anchored at the Kafka
        message's producer timestamp when given (broker queueing counts
        against the allowance), else at arrival."""
        allowance = self.cfg.engine.request_deadline_seconds
        if allowance <= 0:
            return None
        now_wall = time.time()
        anchor = now_wall if wall_anchor_s is None else wall_anchor_s
        return time.perf_counter() + (anchor - now_wall) + allowance

    @staticmethod
    def _message_wall_ts(message) -> float | None:
        """Producer wall-clock seconds of a Kafka message, if stamped."""
        try:
            ts_type, ts_ms = message.timestamp()
        except Exception:
            return None
        if ts_type == 0 or ts_ms is None or ts_ms <= 0:
            return None
        return ts_ms / 1000.0

    # --- at-least-once commits (kafka.commit_after_process) ---------------
    def _note_message_polled(self, msg) -> None:
        """Anchor the partition's commit watermark at the first polled
        offset (poll order is offset order within a partition)."""
        if not self._commit_enabled or msg.offset() < 0:
            return
        self._commit_next.setdefault((msg.topic(), msg.partition()), msg.offset())

    def _note_message_done(self, msg) -> None:
        """A message's handling ended (answered, errored, timed out or
        deduped): advance its partition's contiguous-completion watermark
        and commit it."""
        if not self._commit_enabled or msg.offset() < 0:
            return
        tp = (msg.topic(), msg.partition())
        done = self._done_offsets.setdefault(tp, set())
        done.add(msg.offset())
        nxt = self._commit_next.setdefault(tp, msg.offset())
        advanced = False
        while nxt in done:
            done.discard(nxt)
            nxt += 1
            advanced = True
        if advanced:
            self._commit_next[tp] = nxt
            try:
                self.kafka.commit_offset(tp[0], tp[1], nxt)
            except Exception as e:
                logger.error("offset commit failed for %s: %s", tp, e)

    def _seen_message_id(self, message_id) -> bool:
        """True when this id was already answered (or is in flight) in this
        process lifetime, or replayed from the journal."""
        return self._dedupe.seen(message_id)

    @property
    def _seen_ids(self) -> set:
        """The dedupe ring's id set (tests)."""
        return self._dedupe._ids

    # --- conversation plumbing ------------------------------------------
    def _payload_error(self, payload: dict) -> Response | None:
        """The chat endpoints' validation, and the admission gate during a
        graceful drain (a retryable 503)."""
        if self._draining:
            return Response.json(
                {"detail": "server shutting down; retry with backoff",
                 "retryable": True}, status=503,
            )
        missing = [k for k in ("conversation_id", "message", "user_id") if k not in payload]
        if missing:
            return Response.json({"detail": f"missing fields: {missing}"}, status=400)
        return None

    async def _conversation_inputs(
        self, payload: dict, *, payload_user_id: bool = True
    ) -> tuple[str, str, str, list]:
        """``(conversation_id, user_id, user_context, chat_history)``: the
        one place a request's conversation state is assembled, so the
        ``conversation_id`` that keys the session KV cache and the
        context/history fetch never drift apart. The HTTP paths take
        ``user_id`` from the payload; the Kafka path keeps the stored one
        (``payload_user_id=False``), so a message field cannot re-key whose
        transactions are retrieved."""
        conversation_id = payload["conversation_id"]
        user_context, stored_user_id = await self.store.get_context(conversation_id)
        chat_history = await self.store.get_history(conversation_id)
        user_id = stored_user_id
        if payload_user_id and "user_id" in payload:
            user_id = payload["user_id"]
        return conversation_id, user_id, user_context, chat_history

    # --- tracing ----------------------------------------------------------
    @staticmethod
    def _kafka_trace_id(message_value: dict | None) -> str | None:
        """A Kafka message's own trace id: its ``message_id`` (the id the
        journal and the dedupe ring key on), or None."""
        if message_value is None:
            return None
        mid = message_value.get("message_id")
        return str(mid) if mid is not None else None

    @staticmethod
    def _http_trace_id(request: Request) -> str:
        """The client's ``x-trace-id`` header, else a fresh id."""
        return request.headers.get("x-trace-id") or uuid.uuid4().hex[:16]

    @staticmethod
    def _trace_ingress(trace_id: str, source: str, conversation_id: str) -> None:
        if TRACER.enabled:
            TRACER.event("ingress", trace_id, track="ingress",
                         args={"source": source, "conversation_id": conversation_id})

    # --- HTTP handlers --------------------------------------------------
    async def health(self, request: Request) -> Response:
        return Response.json({"status": "healthy"})

    async def metrics(self, request: Request) -> Response:
        return Response.text(METRICS.render_prometheus(),
                             content_type="text/plain; version=0.0.4")

    async def debug_trace(self, request: Request) -> Response:
        """``GET /debug/trace/<trace_id>``: that request's timeline as Chrome
        trace-event JSON (open it in Perfetto)."""
        trace_id = request.path.rsplit("/", 1)[-1]
        if not trace_id:
            return Response.json({"detail": "missing trace id"}, status=400)
        export = TRACER.export(trace_id)
        if not export["traceEvents"]:
            return Response.json(
                {"detail": f"no events for trace_id {trace_id!r} "
                           "(expired from the ring, or never traced)"},
                status=404,
            )
        return Response.json(export)

    async def chat(self, request: Request) -> Response:
        """The batch REST path: the agent graph's ``query``."""
        payload = request.json()
        err = self._payload_error(payload)
        if err is not None:
            return err
        conversation_id, user_id, user_context, chat_history = (
            await self._conversation_inputs(payload)
        )
        trace_id = self._http_trace_id(request)
        self._trace_ingress(trace_id, "http:/chat", conversation_id)
        result = await self.agent.query(
            payload["message"], user_id, user_context, chat_history,
            conversation_id=conversation_id, deadline=self._request_deadline(),
            trace_id=trace_id,
        )
        body = {
            "response": result["response"],
            "retrieved_transactions_count": result["retrieved_transactions_count"],
        }
        if result.get("plot_data_uri"):
            body["plot_data_uri"] = result["plot_data_uri"]
        return Response.json(body)

    async def chat_stream(self, request: Request) -> Response | StreamingResponse:
        """Server-sent events of the whole event protocol."""
        payload = request.json()
        err = self._payload_error(payload)
        if err is not None:
            return err
        conversation_id, user_id, user_context, chat_history = (
            await self._conversation_inputs(payload)
        )
        deadline = self._request_deadline()
        trace_id = self._http_trace_id(request)
        self._trace_ingress(trace_id, "http:/chat/stream", conversation_id)

        async def events():
            updates = self.agent.stream_with_status(
                payload["message"], user_id, user_context, chat_history,
                conversation_id=conversation_id, deadline=deadline, trace_id=trace_id,
            )
            cap = (max(1, self.cfg.engine.decode_loop_depth)
                   * max(1, self.cfg.engine.freerun_rounds))
            async for update in _repace_bursts(
                    updates, self.cfg.engine.decode_loop_depth, burst_cap=cap):
                yield sse_event(update)

        return StreamingResponse(chunks=events())

    async def upsert_transactions(self, request: Request) -> Response:
        """Ingestion: ``{"user_id": ..., "transactions": [{"text": ...,
        "date"?: unix-ts, ...metadata}]}`` into the retriever's
        ``upsert_transactions``."""
        if self.retriever is None:
            return Response.json({"detail": "no retriever configured"}, status=503)
        payload = request.json()
        missing = [k for k in ("user_id", "transactions") if k not in payload]
        if missing:
            return Response.json({"detail": f"missing fields: {missing}"}, status=400)
        rows = payload["transactions"]
        if not isinstance(rows, list) or not all(
            isinstance(r, dict) and r.get("text") for r in rows
        ):
            return Response.json(
                {"detail": "transactions must be [{text, date?, ...metadata}]"}, status=400
            )
        try:
            count = await asyncio.to_thread(self._ingest_rows, str(payload["user_id"]), rows)
        except (TypeError, ValueError) as e:
            return Response.json({"detail": f"bad transaction row: {e}"}, status=400)
        return Response.json({"upserted": count})

    def _ingest_rows(self, user_id: str, rows: list[dict]) -> int:
        """Upsert (blocking; the callers run it in a thread). A row without
        a ``date`` is stamped with now; a malformed date raises
        ``ValueError``."""
        texts = [str(r["text"]) for r in rows]
        now = self.retriever.now()
        dates = [float(r["date"]) if "date" in r else now for r in rows]
        metadatas = [{k: v for k, v in r.items() if k not in ("text", "date")} for r in rows]
        self.retriever.upsert_transactions(user_id, texts, dates=dates, metadatas=metadatas)
        return len(texts)

    # --- Kafka worker loop ----------------------------------------------
    async def process_message(self, message, message_value: dict | None = None) -> bool:
        """Handle one user message end to end. True only when the client
        was answered (the stream completed); False for drops, errors and
        sheds, so only answered ids stay in the dedupe ring."""
        if message_value is None:
            message_value = json.loads(message.value().decode("utf-8"))
        msg = message_value["message"]
        conversation_id = message_value["conversation_id"]
        full_message = ""
        logger.info("Received message from Kafka: |%s| %s", conversation_id, msg)

        try:
            conversation_id, user_id, context, chat_history = (
                await self._conversation_inputs(message_value, payload_user_id=False)
            )
        except Exception as e:
            logger.error("Error retrieving context or history for conversation %s: %s",
                         conversation_id, e)
            return False

        # stream_flush_tokens > 1 coalesces that many chunks into one produce
        flush_every = max(1, self.cfg.engine.stream_flush_tokens)
        pending_chunks: list[str] = []

        def flush_pending() -> None:
            if pending_chunks:
                text = "".join(pending_chunks)
                pending_chunks.clear()
                self.kafka.produce_message(
                    AI_RESPONSE_TOPIC, conversation_id, response_chunk(message_value, text)
                )
                logger.debug("Processed chunk: %s", text)

        trace_id = self._kafka_trace_id(message_value) or uuid.uuid4().hex[:16]
        self._trace_ingress(trace_id, f"kafka:{USER_MESSAGE_TOPIC}", conversation_id)
        updates = self.agent.stream_with_status(
            msg, user_id, context, chat_history, conversation_id=conversation_id,
            deadline=self._request_deadline(self._message_wall_ts(message)),
            trace_id=trace_id,
        )
        try:
            async for update in updates:
                if update["type"] == "response_chunk":
                    chunk_text = update["content"]
                    full_message += chunk_text
                    pending_chunks.append(chunk_text)
                    if len(pending_chunks) >= flush_every:
                        flush_pending()
                elif update["type"] == "plot":
                    self.kafka.produce_message(
                        AI_RESPONSE_TOPIC, conversation_id,
                        plot_chunk(message_value, update["data_uri"]),
                    )
                elif update["type"] == "complete":
                    flush_pending()  # never reorder text after the marker
                    self.kafka.produce_message(
                        AI_RESPONSE_TOPIC, conversation_id, complete_chunk(message_value)
                    )
                    logger.info("Complete message sent to Kafka for conversation %s",
                                conversation_id)
                # status and retrieval_complete events are not forwarded
        except Exception as e:
            logger.error("Error streaming LLM response: %s", e)
            # text the client was owed goes out before the error marker
            try:
                flush_pending()
            except Exception:
                pass
            # a structured failure (deadline shed, overload, shutdown)
            # carries its code and retryable flag
            self.kafka.produce_error_message(
                AI_RESPONSE_TOPIC, conversation_id,
                error_chunk(
                    message_value,
                    code=getattr(e, "code", None),
                    retryable=True if getattr(e, "retryable", False) else None,
                ),
            )
            return False
        finally:
            # the engine handle's slot and pages are released in the
            # generator's finally, which a consumer cancelled outside
            # __anext__ (the watchdog) would otherwise leave to the GC
            await updates.aclose()

        try:
            await self.store.save_ai_message(conversation_id=conversation_id,
                                             message=full_message, user_id=user_id)
            logger.info("Message saved to DB for conversation %s", conversation_id)
        except Exception as e:
            logger.error("Error saving AI message to DB: %s", e)
        return True

    async def process_upsert(self, message) -> None:
        """The ``transaction_upsert`` topic: the body of ``POST /transactions``."""
        payload = json.loads(message.value().decode("utf-8"))
        rows = payload.get("transactions") or []
        user_id = str(payload.get("user_id", ""))
        if not user_id or not all(isinstance(r, dict) and r.get("text") for r in rows):
            logger.error("malformed transaction_upsert message; dropped")
            return
        count = await asyncio.to_thread(self._ingest_rows, user_id, rows)
        logger.info("ingested %d transactions for user %s via Kafka", count, user_id)

    async def _process_with_watchdog(
        self, msg, message_value: dict | None, prev: asyncio.Task | None
    ) -> bool:
        """One in-flight message: wait for the same conversation's previous
        message, then run under the watchdog. Returns whether it was
        answered (False on a timeout or an error)."""
        if prev is not None:
            try:
                await asyncio.shield(prev)
            except Exception:
                pass  # the predecessor's failure went out on its own stream
        watchdog = self.cfg.engine.watchdog_seconds
        task = asyncio.create_task(self.process_message(msg, message_value))
        try:
            return bool(await asyncio.wait_for(asyncio.shield(task), timeout=watchdog))
        except asyncio.TimeoutError:
            logger.error("Message processing timed out after %s seconds", watchdog)
            TRACER.anomaly(
                "watchdog_timeout", self._kafka_trace_id(message_value),
                args={"watchdog_seconds": watchdog,
                      "conversation_id": (message_value or {}).get("conversation_id")},
            )
            # cancel the generation and wait for its cleanup (the slot and
            # pages released) before the timeout chunk goes out
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
            try:
                if message_value is not None:
                    self.kafka.produce_error_message(
                        AI_RESPONSE_TOPIC, message_value["conversation_id"],
                        timeout_chunk(message_value),
                    )
            except Exception as e:
                logger.error("Failed to send timeout error message: %s", e)
            return False
        except asyncio.CancelledError:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
            raise
        except Exception as e:
            logger.error("Error processing message: %s", e)
            return False

    def _spawn_message_task(self, msg) -> None:
        try:
            message_value = json.loads(msg.value().decode("utf-8"))
            conv_id = message_value.get("conversation_id", "")
        except Exception:
            message_value = None  # malformed: process_message reports it
            conv_id = ""
        mid = None
        if self._commit_enabled and message_value is not None:
            # a message_id already answered (or in flight) is not answered
            # again; its offset still counts as done
            mid = message_value.get("message_id")
            if mid is not None and self._seen_message_id(mid):
                METRICS.inc("finchat_kafka_dedupe_skips_total")
                logger.warning(
                    "duplicate message_id %s (redelivery); already answered, skipping", mid,
                )
                self._note_message_done(msg)
                return
        prev = self._conv_tails.get(conv_id)
        task = asyncio.create_task(self._process_with_watchdog(msg, message_value, prev))
        self._inflight.add(task)
        if conv_id:
            self._conv_tails[conv_id] = task

        def _done(t: asyncio.Task, conv_id=conv_id, mid=mid) -> None:
            self._inflight.discard(t)
            if conv_id and self._conv_tails.get(conv_id) is t:
                del self._conv_tails[conv_id]
            answered = not t.cancelled() and t.exception() is None and bool(t.result())
            if mid is not None and not answered:
                # never answered: a producer retry is reprocessed
                self._dedupe.forget(mid)
            elif mid is not None and self._journal is not None:
                # answered: journaled under the message's partition, fsynced
                # before the watermark commit below
                self._journal.append(mid, partition=msg.partition())
            self._note_message_done(msg)

        task.add_done_callback(_done)

    def _max_inflight(self) -> int:
        """The poll gate: one full batch of the engine."""
        return max(self.cfg.engine.max_seqs, 1)

    async def consume_messages(self) -> None:
        """Poll Kafka and fan messages out as concurrent tasks, so many
        conversations batch onto the engine together. Polling stops while a
        full batch is in flight, so the consumer group spreads the load."""
        while self._running:
            try:
                if len(self._inflight) >= self._max_inflight():
                    await asyncio.wait(set(self._inflight), return_when=asyncio.FIRST_COMPLETED)
                    continue
                # in a worker thread: the confluent backend's poll blocks up
                # to 100 ms, which would stall every in-flight stream
                msg = await asyncio.to_thread(self.kafka.poll_message)
                if msg is not None:
                    self._note_message_polled(msg)
                if msg is not None and msg.topic() == TRANSACTION_UPSERT_TOPIC:
                    try:
                        await self.process_upsert(msg)
                    except Exception as e:
                        logger.error("Error ingesting transactions: %s", e)
                    finally:
                        self._note_message_done(msg)
                elif msg is not None:
                    self._spawn_message_task(msg)
                    await asyncio.sleep(0)  # let the new task reach the engine
                else:
                    await asyncio.sleep(0.01)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.error("Error in message consumption: %s", e)
                await asyncio.sleep(1)


def _refuse_unported(cfg: AppConfig, retriever) -> None:
    """The config planes the port does not carry yet, refused by name."""
    refused = []
    if cfg.fleet.replicas > 1:
        refused.append(f"fleet.replicas={cfg.fleet.replicas} (the engine fleet)")
    if cfg.fabric.enabled:
        refused.append("fabric.enabled (the warm-state fabric)")
    if cfg.pod.host_id:
        refused.append(f"pod.host_id={cfg.pod.host_id!r} (the multi-host pod plane)")
    if cfg.model.checkpoint_path:
        refused.append("model.checkpoint_path (the checkpoint loader)")
    if cfg.model.tokenizer_path:
        refused.append("model.tokenizer_path (HuggingFace tokenizers)")
    if retriever is None:
        refused.append("a missing retriever= (the embedding retriever; pass one in)")
    if refused:
        raise NotImplementedError("build_app: not ported yet: " + "; ".join(refused))


def build_app(cfg: AppConfig | None = None, *, store: ConversationStore | None = None,
              kafka: KafkaClient | None = None,
              tool_generator: TextGenerator | None = None,
              response_generator: TextGenerator | None = None,
              retriever=None, device: str | torch.device = "cuda") -> App:
    """Assemble a worker from config, with injection points for tests and
    development. The engine (``model.preset`` other than ``"stub"``, where
    a generator is not injected) runs on ``device``."""
    cfg = cfg or load_config()
    _refuse_unported(cfg, retriever)
    TRACER.configure(enabled=cfg.tracing.enabled, ring_events=cfg.tracing.ring_events,
                     flight_dir=cfg.tracing.flight_dir)
    store = store or make_store(cfg.store)
    kafka = kafka or KafkaClient(cfg.kafka)

    scheduler = None
    tokenizer = None
    if tool_generator is None or response_generator is None:
        tool_gen, resp_gen, scheduler, tokenizer = build_generators(cfg, device)
        tool_generator = tool_generator or tool_gen
        response_generator = response_generator or resp_gen

    system_prompt, tool_prompt = load_prompts()
    agent = LLMAgent(
        tool_generator, response_generator, retriever, system_prompt, tool_prompt,
        response_sampling=SamplingParams(
            temperature=cfg.engine.temperature, top_p=cfg.engine.top_p,
            top_k=cfg.engine.top_k, max_new_tokens=cfg.engine.max_new_tokens,
        ),
        retrieval_overlap=cfg.engine.retrieval_overlap,
        tool_streaming=cfg.engine.tool_streaming,
    )
    # ingestion works with any retriever that has upsert_transactions
    app_retriever = retriever if hasattr(retriever, "upsert_transactions") else None
    app = App(cfg, agent=agent, store=store, kafka=kafka, scheduler=scheduler,
              retriever=app_retriever)
    if app._prefix_cache_enabled and tokenizer is not None:
        app._registered_heads = register_prompt_prefixes(agent, scheduler, tokenizer)
    return app
