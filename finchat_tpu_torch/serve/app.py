"""The serving app: the Kafka worker loop and the HTTP surface (own copy of
the JAX package's ``serve/app.py``).

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
  ``upsert_transactions``: rows are embedded on the device into the vector
  index, which snapshots to ``vector.persist_path`` (debounced on ingest,
  forced at shutdown) so retrieval is not empty at boot.
- ``drain_and_stop``: the graceful shutdown. Admission stops, in-flight
  streams get ``shutdown.deadline_seconds`` to complete, the fleet's
  supervisor stops, the stragglers are preempted with a retryable
  ``shutting_down`` error, the session entries spill, and nothing is left
  on any pool.
- The engine fleet (serve/fleet.py): with ``fleet.replicas`` > 1 every chat
  path (HTTP and Kafka) takes its agent from ``EngineFleet.agent_for``, the
  conversation-affinity route that also migrates session bytes; with no
  live replica the client gets a retryable error. Each replica registers
  the shared prompt heads on its own device state, again after its rebuilds
  (the refresh loop) and eagerly after a respawn.
- The warm-state fabric (engine/warm_fabric.py, ``fabric.enabled`` with a
  ``fabric.path``): one a process, shared by every replica's session tier
  and shared heads, so a head is prefilled once a fleet and any replica
  resumes any conversation warm.
- The pod plane (serve/pod.py, ``pod.host_id``): the app's
  ``PodCoordinator`` starts after the consumer is set up (its partition
  assignment is the adoption baseline), is attached to every scheduler
  (session pulls before admission), and stops before the fleet.

``build_app`` assembles a worker from an ``AppConfig``. The model comes
from ``model.checkpoint_path`` (an HF safetensors checkpoint, quantized at
load with ``model.quant``) or from a seeded generator, its tokenizer from
``model.tokenizer_path`` (an HF tokenizer). Without an injected
``retriever=`` it builds the retriever the JAX package builds: the
embedding encoder of ``embed.preset`` (``embed.checkpoint_path`` and
``embed.tokenizer_path``, or random weights from a seeded generator, at
``embed.quant``), then a ``QdrantRetriever`` when
``vector.url`` is set, else a ``DeviceVectorIndex`` (restored from
``vector.snapshot_base()`` when set) behind an ``EmbedMicrobatcher`` and a
``TransactionRetriever``. ``fleet.replicas`` > 1 builds that many engine
replicas over one parameter tree behind an ``EngineFleet``, with
``fleet.roles`` typing them into prefill and serving pools
(serve/disagg.py); the ``stub`` preset builds no fleet and no fabric. It
refuses, with an error that names the plane, what the port does not carry
yet: a mesh of more than one device. The engines, the encoder and the index
run on ``cuda`` unless the caller passes ``device="cpu"``.
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
from finchat_tpu_torch.checkpoints.bert_loader import load_bert_params
from finchat_tpu_torch.checkpoints.hf_loader import load_llama_params
from finchat_tpu_torch.embed.batcher import EmbedMicrobatcher
from finchat_tpu_torch.embed.encoder import EMBED_PRESETS, EmbeddingEncoder, init_bert_params
from finchat_tpu_torch.embed.index import DeviceVectorIndex
from finchat_tpu_torch.engine.engine import InferenceEngine, check_tp_servable
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
from finchat_tpu_torch.parallel.mesh import AXES, MeshSpec, mesh_devices
from finchat_tpu_torch.serve.fleet import LIVE, DedupeRing, EngineFleet, EngineReplica
from finchat_tpu_torch.serve.http import HTTPServer, Request, Response, StreamingResponse, sse_event
from finchat_tpu_torch.tools.retrieval import TransactionRetriever
from finchat_tpu_torch.utils.config import (
    AI_RESPONSE_TOPIC,
    TRANSACTION_UPSERT_TOPIC,
    USER_MESSAGE_TOPIC,
    AppConfig,
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
    a few string comparisons, a registration at most once a day. With a
    fleet, every live replica is checked: a registration belongs to one
    device state."""
    while app._running:
        try:
            for target in app._prefix_targets():
                await _maybe_refresh_prefix_cache(target)
        except Exception as e:  # best-effort: the cache is an optimization
            logger.error("prefix cache refresh error: %s", e)
        await asyncio.sleep(app._prefix_refresh_check_s)


class _ReplicaPrefixView:
    """A fleet replica as ``_maybe_refresh_prefix_cache``'s target: the
    app's attribute surface, with the registered heads kept on the replica
    (its shared heads live in its own device state)."""

    def __init__(self, app: "App", rep: EngineReplica):
        self._rep = rep
        self._prefix_cache_enabled = app._prefix_cache_enabled
        self.scheduler = rep.scheduler
        self.agent = rep.agent

    @property
    def _registered_heads(self) -> set:
        return self._rep.registered_heads

    @_registered_heads.setter
    def _registered_heads(self, value: set) -> None:
        self._rep.registered_heads = set(value)


def _make_rebuild_hook(rep: EngineReplica):
    """One replica's ``on_rebuild`` callback: the rebuild dropped its heads,
    so they are marked unregistered there (the refresh loop registers them
    again). Keyed, so ``App.start`` adds it once across restarts."""

    def hook() -> None:
        rep.registered_heads.clear()

    hook.key = ("fleet_heads", rep.replica_id)
    return hook


def _load_model_artifacts(cfg: AppConfig, device: str | torch.device = "cuda",
                          mesh=None) -> tuple:
    """(model config, params, tokenizer, device). ``model.checkpoint_path``
    loads an HF safetensors checkpoint (``checkpoints/hf_loader.py``) with
    ``model.quant`` applied at load, one leaf at a time, so the
    full-precision tree never exists on the device; without one, random
    weights from a ``torch.Generator`` seeded with ``model.seed``, made on
    the device (int8/int4 leaves quantized as they are made). The tokenizer
    is ``model.tokenizer_path``'s HF tokenizer; without one, and where the
    model's rows are wider than the byte tokenizer's 260 ids, a
    ``ByteTokenizer`` as wide as the rows (its ids past 255 decode to
    nothing), so the decision's grammar masks are as wide as the logits
    they mask. An HF tokenizer of another width than the rows is refused:
    the JAX package's app builds it, then fails at the decision's grammar
    mask (a mask of the tokenizer's width cannot mask a logits row of the
    model's). With a ``mesh`` (a tensor-parallel rank) each leaf is cut to
    this rank's slice on its device as soon as it is made or loaded
    (``parallel/sharding.leaf_sharder``): the rank holds its shard and at
    most one whole leaf, never the whole tree."""
    device = torch.device(device)
    config = PRESETS[cfg.model.preset]
    if cfg.model.dtype:
        config = dataclasses.replace(config, dtype=getattr(torch, cfg.model.dtype))
    if not cfg.model.tokenizer_path and config.vocab_size > _BYTE_VOCAB:
        tokenizer = ByteTokenizer(vocab_size=config.vocab_size)
    else:
        tokenizer = get_tokenizer(cfg.model.tokenizer_path)
    if cfg.model.tokenizer_path and tokenizer.vocab_size != config.vocab_size:
        raise ValueError(
            f"model.tokenizer_path: the tokenizer has {tokenizer.vocab_size} ids, the model "
            f"{config.vocab_size} logits rows (preset {cfg.model.preset}); the decision's "
            "grammar mask must be as wide as the rows")
    shard = None
    if mesh is not None:
        from finchat_tpu_torch.parallel.sharding import leaf_sharder

        shard = leaf_sharder(mesh, device)
    if cfg.model.checkpoint_path:
        params = load_llama_params(cfg.model.checkpoint_path, config, device=device,
                                   quant=cfg.model.quant, quant_group=cfg.model.quant_group,
                                   leaf_transform=shard)
    else:
        logger.warning("no checkpoint configured; using RANDOM weights (preset=%s)",
                       cfg.model.preset)
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.model.seed)
        if cfg.model.quant:
            params = init_quantized_params(config, gen, device, mode=cfg.model.quant,
                                           group_size=cfg.model.quant_group,
                                           leaf_transform=shard)
        else:
            params = init_params(config, gen, device, leaf_transform=shard)
    return config, params, tokenizer, device


def make_engine_replica(cfg: AppConfig, artifacts: tuple, replica_id: str | None = None,
                        fabric=None, mesh=None, channel=None
                        ) -> tuple[EngineGenerator, ContinuousBatchingScheduler]:
    """One engine over the shared artifacts: its own KV page pool, scheduler
    and session cache over the artifacts' parameter tensors (an already
    quantized tree is kept as it is, so replicas share it too), warmed up
    first when ``engine.warmup_on_start`` is set. A ``replica_id`` labels
    the scheduler's metrics (``METRICS.labeled(replica=...)``) and stamps its
    fault sites. ``fabric`` (engine/warm_fabric.py) makes the replica's
    session tier the fleet's shared one, and its shared prompt heads restore
    from and publish to it. With a ``mesh`` the engine is rank 0 of a
    tensor-parallel group, and ``channel`` mirrors its calls on the other
    ranks (``parallel/ranks.Leader``, kept as ``engine.leader``)."""
    config, params, tokenizer, device = artifacts
    metrics = METRICS.labeled(replica=replica_id) if replica_id is not None else None
    engine = InferenceEngine(config, params, cfg.engine, device=device,
                             quant=cfg.model.quant, quant_group=cfg.model.quant_group, mesh=mesh)
    if channel is not None:
        from finchat_tpu_torch.parallel.ranks import Leader

        engine.leader = Leader(engine, channel)
    if cfg.engine.warmup_on_start:
        engine.warmup()
    scheduler = ContinuousBatchingScheduler(engine, eos_id=tokenizer.eos_id, metrics=metrics,
                                            replica_id=replica_id, fabric=fabric)
    return EngineGenerator(scheduler, tokenizer), scheduler


def make_warm_fabric(cfg: AppConfig):
    """The process's warm-state fabric, or None. Best-effort: an unusable
    path logs and serves without it (each replica then keeps its own session
    directory)."""
    if not (cfg.fabric.enabled and cfg.fabric.path):
        if cfg.fabric.enabled:
            logger.warning("fabric.enabled is set but fabric.path is empty; the warm-state "
                           "fabric stays off")
        return None
    from finchat_tpu_torch.engine.warm_fabric import WarmFabric

    try:
        return WarmFabric(cfg.fabric.path, cfg.engine.session_cache_disk_bytes,
                          kv_quant=cfg.engine.kv_quant)
    except Exception as e:
        logger.error("warm-state fabric unavailable at %s: %s", cfg.fabric.path, e)
        return None


def build_generators(cfg: AppConfig, device: str | torch.device = "cuda", fabric=None,
                     mesh=None, channel=None
                     ) -> tuple[TextGenerator, TextGenerator,
                                ContinuousBatchingScheduler | None, object]:
    """(tool_generator, response_generator, scheduler, tokenizer):
    ``model.preset == "stub"`` gives canned generators and no engine;
    anything else one engine whose scheduler serves both agent roles (rank
    0 of a tensor-parallel group with a ``mesh`` and its ``channel``)."""
    if cfg.model.preset == "stub":
        stub = StubGenerator(default="I'm Penny, here to help with your finances.")
        return stub, stub, None, get_tokenizer()
    artifacts = _load_model_artifacts(cfg, mesh.device if mesh is not None else device, mesh=mesh)
    generator, scheduler = make_engine_replica(cfg, artifacts, fabric=fabric, mesh=mesh,
                                               channel=channel)
    return generator, generator, scheduler, artifacts[2]


def _refuse_mesh_planes(cfg: AppConfig, n_devices: int) -> None:
    """The planes a mesh does not serve yet, refused by name before any
    rank starts: the engine's (``check_tp_servable``) and the app's own."""
    sizes = dict(zip(AXES, MeshSpec.from_config(cfg.mesh).resolve(n_devices)))
    check_tp_servable(PRESETS[cfg.model.preset], sizes)
    if cfg.fleet.replicas > 1:
        raise NotImplementedError(
            f"mesh: a fleet of {cfg.fleet.replicas} replicas (fleet.roles "
            f"{cfg.fleet.roles!r}) over a mesh: each replica needs a rank group of its own, "
            "not served yet")
    if cfg.pod.host_id:
        raise NotImplementedError(
            f"mesh: the pod plane (pod.host_id {cfg.pod.host_id!r}) over a mesh is not served "
            "yet")


def _start_mesh(cfg: AppConfig, devices: list) -> tuple:
    """Rank 0 of a served mesh: the followers spawned (each loads its own
    shard), the process group joined, the mesh and the channel built.
    Returns ``(mesh, channel, procs)``."""
    from finchat_tpu_torch.parallel.mesh import build_mesh, default_backend, initialize_distributed
    from finchat_tpu_torch.parallel.ranks import RankChannel, rendezvous, spawn_followers

    backend = default_backend(devices[0])
    init_method = rendezvous()
    procs = spawn_followers(cfg, devices, backend, init_method)
    try:
        if devices[0].type == "cuda":
            torch.cuda.set_device(devices[0])
        initialize_distributed(len(devices), 0, backend=backend, init_method=init_method,
                               device=devices[0])
        mesh = build_mesh(MeshSpec.from_config(cfg.mesh), devices, backend)
        return mesh, RankChannel(mesh), procs
    except BaseException:
        for p in procs:
            p.terminate()
        raise


class App:
    """One worker process: HTTP surface, Kafka consume loop and engine (or
    engine fleet)."""

    def __init__(self, cfg: AppConfig, *, agent: LLMAgent, store: ConversationStore,
                 kafka: KafkaClient, scheduler: ContinuousBatchingScheduler | None = None,
                 retriever=None, fleet: EngineFleet | None = None):
        self.cfg = cfg
        self.agent = agent
        self.store = store
        self.kafka = kafka
        self.scheduler = scheduler
        # the engine fleet: every chat path routes its conversation through
        # _agent_for; ``agent`` and ``scheduler`` stay replica 0's, started
        # and stopped through the fleet
        self.fleet = fleet
        # a served mesh (parallel/ranks.RankGroup): this process is rank 0;
        # stop() stops and joins the other ranks
        self.ranks = None
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
        # the ring lives at the router level: with a fleet it is the fleet's,
        # so a redelivery to a sibling replica finds the answer recorded
        self._dedupe = fleet.dedupe if fleet is not None else DedupeRing()
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
        # the pod plane (serve/pod.py): with pod.host_id set this process is
        # one host of a pod, with liaison heartbeats to its peers, partition
        # adoption (the inherited journals replayed into the dedupe ring) on
        # a peer's death, and session pulls before admission. Off, the app is
        # the plain fleet
        self.pod = None
        if cfg.pod.host_id:
            from finchat_tpu_torch.serve.pod import PodCoordinator

            try:
                self.pod = PodCoordinator(cfg.pod, fleet=fleet, kafka=kafka,
                                          journal=self._journal, dedupe=self._dedupe)
                for sched in self._all_schedulers():
                    sched.pod = self.pod
            except Exception as e:  # the pod plane is best-effort too
                logger.error("pod plane unavailable: %s", e)
                self.pod = None
        # set while drain_and_stop runs: the HTTP chat paths answer a
        # retryable 503
        self._draining = False
        # the vector index's snapshot: when the last one was written, and
        # whether a debounced one is due
        self._last_persist = float("-inf")
        self._persist_dirty = False

    # --- lifespan -------------------------------------------------------
    def _embed_batcher(self):
        """The embedding microbatcher, wherever it is wired: the app's own
        ingestion retriever or the agent's (one object on the default
        on-device path)."""
        return getattr(self.retriever, "batcher", None) or getattr(
            self.agent.retriever, "batcher", None
        )

    async def start(self, serve_http: bool = True) -> None:
        await self.store.check_connection()
        batcher = self._embed_batcher()
        if batcher is not None:
            # the coalescing flusher on the serving loop, so the threadsafe
            # ingest path rides the same window as the queries
            batcher.bind_loop()
        topics = [USER_MESSAGE_TOPIC]
        if self.retriever is not None:
            topics.append(TRANSACTION_UPSERT_TOPIC)
        self.kafka.setup_consumer(topics=topics)
        if self.fleet is not None:
            # a rebuild drops its own replica's heads only (the refresh loop
            # registers them again there); a respawn registers them at once
            for rep in self.fleet.replicas:
                hook = _make_rebuild_hook(rep)
                if hook.key not in {getattr(cb, "key", None) for cb in rep.scheduler.on_rebuild}:
                    rep.scheduler.on_rebuild.append(hook)
            if self._respawn_heads not in self.fleet.on_respawn:
                self.fleet.on_respawn.append(self._respawn_heads)
            await self.fleet.start()
        elif self.scheduler is not None:
            if self._on_engine_rebuild not in self.scheduler.on_rebuild:
                self.scheduler.on_rebuild.append(self._on_engine_rebuild)
            await self.scheduler.start()
        if self.pod is not None:
            # after setup_consumer: the coordinator takes this host's real
            # partition assignment as its adoption baseline
            await self.pod.start()
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
        batcher = self._embed_batcher()
        if batcher is not None:
            await batcher.close()
        if self.pod is not None:
            await self.pod.stop()
        if self.fleet is not None:
            await self.fleet.stop()
        elif self.scheduler is not None:
            await self.scheduler.stop()
        if self.ranks is not None:
            # a served mesh: the followers stop and are joined, no rank left
            await asyncio.to_thread(self.ranks.close)
        # the snapshot's compression and file IO off the loop
        await asyncio.to_thread(self._persist_index, True)
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
        # the supervisor goes first: a respawn's rebuild racing a replica's
        # shutdown_drain on the same engine could leave slots or pages behind
        if self.fleet is not None:
            await self.fleet.stop_supervisor()
        # the stragglers' handles fail with the retryable shutting_down
        # error and their KV spills; each loop stops first, so no dispatch
        # races the offload
        for sched in self._all_schedulers():
            try:
                await sched.shutdown_drain()
            except Exception as e:
                logger.error("scheduler shutdown drain failed: %s", e)
        # the straggler tasks emit their error chunks and commit their offsets
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        METRICS.observe("finchat_durability_shutdown_drain_seconds", time.perf_counter() - t0)
        # flight dumps are written by threads: join them off the loop
        await asyncio.to_thread(TRACER.flush_dumps)
        await self.stop()

    # a snapshot rewrites the whole collection, so ingest saves are
    # debounced; shutdown always forces one
    _PERSIST_DEBOUNCE_S = 30.0

    def _persist_index(self, force: bool = False) -> None:
        """Snapshot the local vector index to ``vector.snapshot_base()``
        (nothing without a persist path or a local index, as with the
        external Qdrant). Within the debounce window a save is only marked
        due; the consume loop writes it once idle."""
        base = self.cfg.vector.snapshot_base()
        if not base or getattr(self.retriever, "index", None) is None:
            return
        now = time.monotonic()
        if not force and now - self._last_persist < self._PERSIST_DEBOUNCE_S:
            self._persist_dirty = True
            return
        try:
            self.retriever.index.save(base)
            self._last_persist = now
            self._persist_dirty = False
        except Exception as e:
            logger.error("failed to persist vector index: %s", e)

    def _on_engine_rebuild(self) -> None:
        """A breaker trip rebuilt the engine's device state and the heads'
        prefilled KV went with it: mark them unregistered, so the refresh
        loop registers them again through the chunked path."""
        self._registered_heads = set()

    # --- fleet routing ------------------------------------------------------
    def _all_schedulers(self) -> list:
        if self.fleet is not None:
            return [rep.scheduler for rep in self.fleet.replicas]
        return [self.scheduler] if self.scheduler is not None else []

    def _agent_for(self, conversation_id: str) -> LLMAgent:
        """The agent serving this conversation: the fleet's route (which
        also migrates its session bytes home), else the one agent. Raises
        RuntimeError when no replica is live, or when a rank of a served
        mesh is gone."""
        down = self.ranks.down() if self.ranks is not None and not self.ranks.closed else None
        if down is not None:
            raise RuntimeError(f"mesh: {down}")
        if self.fleet is not None:
            return self.fleet.agent_for(conversation_id)
        return self.agent

    def _prefix_targets(self) -> list:
        """The shared-head refresh targets: each live replica with a fleet,
        else the app itself."""
        if self.fleet is not None:
            return [_ReplicaPrefixView(self, rep) for rep in self.fleet.replicas
                    if rep.state == LIVE and rep.agent is not None]
        return [self]

    async def _respawn_heads(self, rep: EngineReplica) -> None:
        """``fleet.on_respawn``: register the shared heads on a revived
        replica at once (the refresh loop could leave it head-cold for a
        whole interval)."""
        if self._prefix_cache_enabled and rep.agent is not None:
            rep.registered_heads = set()
            await _maybe_refresh_prefix_cache(_ReplicaPrefixView(self, rep))

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
        down = self.ranks.down() if self.ranks is not None and not self.ranks.closed else None
        if down is not None:  # a served mesh lost a rank: not ready, retry elsewhere
            return Response.json({"status": "unhealthy", "detail": f"mesh: {down}",
                                  "retryable": True}, status=503)
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
        try:
            agent = self._agent_for(conversation_id)
        except RuntimeError:
            # the whole fleet is out: the retryable signal the Kafka path sends
            return Response.json({"detail": "no live engine replica; retry with backoff",
                                  "retryable": True}, status=503)
        result = await agent.query(
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
        try:
            agent = self._agent_for(conversation_id)
        except RuntimeError:
            return Response.json({"detail": "no live engine replica; retry with backoff",
                                  "retryable": True}, status=503)

        async def events():
            updates = agent.stream_with_status(
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
        """Embed and upsert (blocking: device work; the callers run it in a
        thread), then snapshot the index (debounced). A row without a
        ``date`` is stamped with now; a malformed date raises
        ``ValueError``."""
        texts = [str(r["text"]) for r in rows]
        now = self.retriever.now()
        dates = [float(r["date"]) if "date" in r else now for r in rows]
        metadatas = [{k: v for k, v in r.items() if k not in ("text", "date")} for r in rows]
        self.retriever.upsert_transactions(user_id, texts, dates=dates, metadatas=metadatas)
        self._persist_index()
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

        try:
            agent = self._agent_for(conversation_id)
        except RuntimeError as e:
            # the whole fleet is out: a retryable error, not a silent drop
            # (the dedupe ring forgets the id)
            logger.error("no replica for conversation %s: %s", conversation_id, e)
            self.kafka.produce_error_message(
                AI_RESPONSE_TOPIC, conversation_id,
                error_chunk(message_value, code="overloaded", retryable=True),
            )
            return False
        trace_id = self._kafka_trace_id(message_value) or uuid.uuid4().hex[:16]
        self._trace_ingress(trace_id, f"kafka:{USER_MESSAGE_TOPIC}", conversation_id)
        updates = agent.stream_with_status(
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
        """The poll gate: a full batch a live replica. OUT and respawning
        replicas are no capacity (a worker polling for the whole fleet in an
        outage hoards what the consumer group should spread); at least one
        batch, so a fleet all out still answers with retryable errors."""
        n_replicas = 1
        if self.fleet is not None:
            n_replicas = max(1, len(self.fleet.live_replicas()))
        return max(self.cfg.engine.max_seqs, 1) * n_replicas

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
                    # a snapshot a debounced ingest left due, written off
                    # the loop once the debounce window has passed
                    if (self._persist_dirty and time.monotonic() - self._last_persist
                            >= self._PERSIST_DEBOUNCE_S):
                        await asyncio.to_thread(self._persist_index)
                    await asyncio.sleep(0.01)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.error("Error in message consumption: %s", e)
                await asyncio.sleep(1)


def build_retriever(cfg: AppConfig, tokenizer=None, device: str | torch.device = "cuda"):
    """The retriever ``build_app`` builds when none is injected, as the JAX
    package builds it: the encoder of ``embed.preset`` on ``device`` at
    ``embed.quant``, its weights from ``embed.checkpoint_path`` (an HF BERT
    checkpoint, ``checkpoints/bert_loader.py``) or random (a
    ``torch.Generator`` seeded with 1), framing texts with
    ``embed.tokenizer_path``'s tokenizer, else ``tokenizer`` (the
    decoder's) or the byte tokenizer; then a ``QdrantRetriever`` when
    ``vector.url`` is set, else the on-device index (restored from
    ``vector.snapshot_base()`` when set) behind an ``EmbedMicrobatcher``
    and a ``TransactionRetriever``."""
    embed_cfg = EMBED_PRESETS[cfg.embed.preset]
    if cfg.embed.checkpoint_path:
        embed_params = load_bert_params(cfg.embed.checkpoint_path, embed_cfg, device=device)
    else:
        logger.warning(
            "no embedding checkpoint configured; using RANDOM weights "
            "(preset=%s) — retrieval rankings will be meaningless", cfg.embed.preset,
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        embed_params = init_bert_params(embed_cfg, gen, device)
    if cfg.embed.tokenizer_path:
        embed_tokenizer = get_tokenizer(cfg.embed.tokenizer_path)
    else:
        if cfg.embed.checkpoint_path:
            logger.warning(
                "embed.checkpoint_path is set but embed.tokenizer_path is "
                "not; falling back to the LLM/byte tokenizer, whose ids "
                "will NOT match the BERT vocab — retrieval rankings will "
                "be meaningless. Set FINCHAT_EMBED_TOKENIZER."
            )
        embed_tokenizer = tokenizer or get_tokenizer()
    encoder = EmbeddingEncoder(
        embed_cfg, embed_params, embed_tokenizer,
        batch_size=cfg.embed.batch_size, quant=cfg.embed.quant, device=device,
    )
    if cfg.vector.api_key and not cfg.vector.url:
        logger.warning(
            "QDRANT_API_KEY is set but QDRANT_URL is not; using the on-device vector "
            "index — set QDRANT_URL to select the external Qdrant backend"
        )
    if cfg.vector.url:
        # an existing, populated Qdrant cluster: the embeddings still run on
        # the device, only the search is external
        from finchat_tpu_torch.tools.qdrant_retriever import QdrantRetriever

        return QdrantRetriever(
            encoder, url=cfg.vector.url, api_key=cfg.vector.api_key,
            collection=cfg.vector.collection, default_limit=cfg.vector.default_limit,
        )
    base = cfg.vector.snapshot_base()
    index = (DeviceVectorIndex.load(base, dim=embed_cfg.dim, device=device) if base
             else DeviceVectorIndex(dim=embed_cfg.dim, device=device))
    # concurrent query embeds and ingest upserts coalesce into shared
    # dispatches; the batcher binds to the serving loop at App.start
    batcher = EmbedMicrobatcher(encoder, window_ms=cfg.embed.batch_window_ms,
                                max_batch=cfg.embed.batch_max)
    return TransactionRetriever(encoder, index, default_limit=cfg.vector.default_limit,
                                batcher=batcher)


def build_app(cfg: AppConfig | None = None, *, store: ConversationStore | None = None,
              kafka: KafkaClient | None = None,
              tool_generator: TextGenerator | None = None,
              response_generator: TextGenerator | None = None,
              retriever=None, device: str | torch.device = "cuda") -> App:
    """Assemble a worker from config, with injection points for tests and
    development. The engines (``model.preset`` other than ``"stub"``, where
    a generator is not injected: one, or ``fleet.replicas`` over one
    parameter tree) and, without an injected ``retriever``, the retriever
    ``build_retriever`` makes run on ``device``.

    A ``mesh`` config that resolves to more than one device
    (``parallel/mesh.mesh_devices``) serves the model tensor-parallel over
    ``model`` and, with ``seq``, a long prompt's prefill split over the seq
    ranks: this process is rank 0 and serves, one follower process a further
    device is spawned (each loads its own shard from the same seed or
    checkpoint), and ``App.stop`` (so ``drain_and_stop``) stops and joins
    them. Refused by name on a mesh: the data, pipe and expert axes, an MoE
    preset, a fleet (and so disagg) and the pod plane."""
    cfg = cfg or load_config()
    TRACER.configure(enabled=cfg.tracing.enabled, ring_events=cfg.tracing.ring_events,
                     flight_dir=cfg.tracing.flight_dir)
    store = store or make_store(cfg.store)
    kafka = kafka or KafkaClient(cfg.kafka)

    scheduler = None
    tokenizer = None
    fleet_replicas: list[EngineReplica] | None = None
    ranks = None
    if tool_generator is None or response_generator is None:
        # the warm-state fabric: one shared session tier and head store for
        # every replica built below (a one-engine worker uses it too: restarts
        # and other processes on the path resume each other's conversations)
        fabric = make_warm_fabric(cfg) if cfg.model.preset != "stub" else None
        devices = (mesh_devices(MeshSpec.from_config(cfg.mesh), device)
                   if cfg.model.preset != "stub" else [])
        if len(devices) > 1:
            _refuse_mesh_planes(cfg, len(devices))
        if cfg.fleet.replicas > 1 and cfg.model.preset != "stub":
            # the engine fleet: N replicas over ONE parameter tree, each with
            # its own pool, scheduler, session cache and labeled metrics;
            # fleet.roles types each into the prefill or the serving pool
            from finchat_tpu_torch.serve.disagg import parse_roles

            roles = parse_roles(cfg.fleet.roles, cfg.fleet.replicas)
            artifacts = _load_model_artifacts(cfg, device)
            tokenizer = artifacts[2]
            fleet_replicas = []
            for i in range(cfg.fleet.replicas):
                gen, sched = make_engine_replica(cfg, artifacts, replica_id=str(i),
                                                 fabric=fabric)
                fleet_replicas.append(EngineReplica(replica_id=str(i), scheduler=sched,
                                                    generator=gen, role=roles[i]))
            scheduler = fleet_replicas[0].scheduler
            tool_generator = tool_generator or fleet_replicas[0].generator
            response_generator = response_generator or fleet_replicas[0].generator
        else:
            mesh = channel = None
            if len(devices) > 1:
                # tensor parallelism: this process is rank 0 and drives the
                # engine; ranks 1.. follow its calls on their shards
                from finchat_tpu_torch.parallel.ranks import RankGroup

                mesh, channel, procs = _start_mesh(cfg, devices)
                ranks = RankGroup(None, procs)
            try:
                tool_gen, resp_gen, scheduler, tokenizer = build_generators(
                    cfg, device, fabric=fabric, mesh=mesh, channel=channel)
            except BaseException:
                if ranks is not None:
                    ranks.close(join_s=5.0)
                raise
            if ranks is not None:
                ranks.attach(scheduler.engine.leader)
            tool_generator = tool_generator or tool_gen
            response_generator = response_generator or resp_gen
    if retriever is None:
        retriever = build_retriever(cfg, tokenizer, device)

    system_prompt, tool_prompt = load_prompts()

    def make_agent(tool_gen, resp_gen) -> LLMAgent:
        return LLMAgent(
            tool_gen, resp_gen, retriever, system_prompt, tool_prompt,
            response_sampling=SamplingParams(
                temperature=cfg.engine.temperature, top_p=cfg.engine.top_p,
                top_k=cfg.engine.top_k, max_new_tokens=cfg.engine.max_new_tokens,
            ),
            retrieval_overlap=cfg.engine.retrieval_overlap,
            tool_streaming=cfg.engine.tool_streaming,
        )

    agent = make_agent(tool_generator, response_generator)
    fleet = None
    if fleet_replicas is not None:
        # an agent a replica (prompts and retriever shared, the generators
        # bound to the replica's scheduler); replica 0's is the app's agent
        fleet_replicas[0].agent = agent
        for rep in fleet_replicas[1:]:
            rep.agent = make_agent(rep.generator, rep.generator)
        fleet = EngineFleet(fleet_replicas, cfg.fleet, num_partitions=kafka.num_partitions)
    # ingestion works with any retriever that has upsert_transactions
    app_retriever = retriever if hasattr(retriever, "upsert_transactions") else None
    app = App(cfg, agent=agent, store=store, kafka=kafka, scheduler=scheduler,
              retriever=app_retriever, fleet=fleet)
    app.ranks = ranks
    if app._prefix_cache_enabled and tokenizer is not None:
        if fleet is not None:
            for rep in fleet.replicas:
                rep.registered_heads = register_prompt_prefixes(rep.agent, rep.scheduler,
                                                                tokenizer)
        else:
            app._registered_heads = register_prompt_prefixes(agent, scheduler, tokenizer)
    return app
