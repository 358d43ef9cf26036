"""Typed configuration tree (own copy of the JAX package's ``utils/config.py``).

Field names, defaults, env names and the order ``load_config`` applies them
in (defaults <- env vars <- JSON file <- overrides) are the reference's, so
a config written for one package reads the same in the other, and a
reference deployment's ``.env`` drops in unchanged.

Product-contract constants: topics ``user_message`` / ``ai_response`` /
``transaction_upsert``, consumer group ``message_consumer``, store
collections ``contexts`` / ``messages``, vector collection
``transactions``.

What the port reads. ``EngineConfig()`` as it stands is served. The serving
planes this port does not carry yet (spec decode, decode loop, free-run,
bounded KV) keep their fields; the scheduler refuses a config that turns one
of them on (engine/scheduler.py ``check_supported``). The prefix and session
KV caches, recompute preemption, the circuit breaker, deadline admission,
grammar-constrained decoding and the partial holds are read by the
scheduler. The serving app (serve/app.py) reads ``watchdog_seconds``,
``stream_flush_tokens``, ``warmup_on_start``, ``request_deadline_seconds``
and ``prefix_cache``, and passes ``retrieval_overlap`` and
``tool_streaming`` to ``LLMAgent``. ``compilation_cache_dir`` is inert here:
it names XLA's persistent compilation cache, and the port's kernels are
built from source into ``finchat_tpu_torch/build/`` keyed by a source hash,
so nothing reads it. The sections of planes not ported yet (``fleet``,
``fabric``, ``pod``, ``mesh``, ``embed``, ``vector``) are carried so the
tree reads the same in both packages; ``build_app`` refuses the settings
that would turn one of them on (a fleet, the fabric, a pod, a mesh of more
than one device), and ``embed``/``vector`` go unread until the embedding
retriever is ported (``build_app`` takes an injected ``retriever=``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any

USER_MESSAGE_TOPIC = "user_message"
AI_RESPONSE_TOPIC = "ai_response"
# transaction rows for vector-index ingestion
TRANSACTION_UPSERT_TOPIC = "transaction_upsert"
GROUP_ID = "message_consumer"
CONTEXT_COLLECTION_NAME = "contexts"
MESSAGE_COLLECTION_NAME = "messages"
TRANSACTION_COLLECTION_NAME = "transactions"


def _env(name: str, default: str = "") -> str:
    return os.getenv(name, default)


def _env_bool(name: str, default: bool) -> bool:
    raw = os.getenv(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")


def _env_int(name: str, default: int) -> int:
    raw = os.getenv(name)
    if raw is None or raw == "":
        return default
    return int(raw)


def _env_float(name: str, default: float) -> float:
    raw = os.getenv(name)
    if raw is None or raw == "":
        return default
    return float(raw)


@dataclass
class KafkaConfig:
    """Transport settings; mirrors reference ``config.py:8-28``."""

    bootstrap_servers: str = ""
    username: str = ""
    password: str = ""
    session_timeout_ms: int = 45_000
    client_id: str = "python-client-1"
    auto_offset_reset: str = "latest"
    # "memory" = in-process broker (tests/dev); "confluent" = librdkafka.
    backend: str = "memory"
    # partitions per topic. The process-wide memory broker is created with
    # this count by the FIRST KafkaClient (an explicitly shared broker
    # wins; a count mismatch warns and the broker's count is used for
    # routing); on the confluent backend it must MATCH how the real topics
    # were created — the fleet router hashes conversation keys mod this
    # count (io/kafka.py partition_for_key), so a mismatch silently breaks
    # the routing ≡ partition-assignment alignment (serve/fleet.py). Also
    # FINCHAT_KAFKA_NUM_PARTITIONS.
    num_partitions: int = 4
    # at-least-once delivery (default off = reference at-most-once parity):
    # disable poll-time auto-commit and commit offsets only AFTER the
    # watchdog-wrapped handler completes, so a worker crash mid-message
    # redelivers it to the group instead of silently losing it. The app
    # pairs this with an in-memory per-message_id dedupe ring so
    # SAME-PROCESS redelivery (rebalance, producer retry) doesn't
    # double-answer; pair with journal.path (JournalConfig) to close the
    # crash-redelivery window too — the answered-id journal replays into
    # the ring at restart (serve/app.py).
    commit_after_process: bool = False
    # memory-broker committed offsets persist to this directory (defaults
    # to journal.path when that is set), so a restart drill that stands up
    # a fresh broker rewinds to the committed watermark exactly like a
    # real consumer group; "" with no journal = in-memory only. The
    # confluent backend ignores this (the real broker is durable).
    # Also FINCHAT_KAFKA_OFFSETS_DIR.
    offsets_dir: str = ""

    def librdkafka_config(self) -> dict[str, str]:
        """Render the confluent-kafka config dict, including the SASL_SSL ↔
        PLAINTEXT switch the reference performs (config.py:15-23)."""
        cfg: dict[str, str] = {"bootstrap.servers": self.bootstrap_servers}
        if self.username and self.password:
            cfg.update(
                {
                    "security.protocol": "SASL_SSL",
                    "sasl.mechanisms": "PLAIN",
                    "sasl.username": self.username,
                    "sasl.password": self.password,
                }
            )
        else:
            cfg["security.protocol"] = "PLAINTEXT"
        return cfg


@dataclass
class StoreConfig:
    """Conversation store; mirrors reference Mongo usage (``database.py``)."""

    mongodb_uri: str = ""
    database_name: str = "conversations"
    # "memory" = in-process store; "mongo" = pymongo (requires the wheel).
    backend: str = "memory"


@dataclass
class VectorConfig:
    """Vector index over user transactions.

    The reference delegates to a remote Qdrant (``tools/qdrant_tool.py``);
    the default backend is an on-device index (brute-force exact cosine)
    with a local durable snapshot (``persist_path``), and ``QDRANT_URL``
    (the reference's env name) selects an external Qdrant instead. Not
    ported yet: the port's ``build_app`` takes an injected retriever and
    reads nothing here.
    """

    url: str = ""
    api_key: str = ""
    collection: str = TRANSACTION_COLLECTION_NAME  # finchat-lint: disable=knob-consistency -- product-contract constant (reference config.py:47 keys the Qdrant collection); config-file override only, by design
    default_limit: int = 10_000  # finchat-lint: disable=knob-consistency -- reference-parity constant (qdrant_tool.py:145); config-file override only, by design
    persist_path: str = ""  # snapshot directory; empty = in-memory only

    def snapshot_base(self) -> str:
        """Snapshot file base: ``<persist_path>/<collection>`` — the
        collection name keys the on-disk layout the way it keys the
        reference's Qdrant collection (config.py:47)."""
        if not self.persist_path:
            return ""
        import pathlib

        return str(pathlib.Path(self.persist_path) / self.collection)


@dataclass
class ModelConfig:
    """Which decoder to serve and how to load it."""

    preset: str = "tiny"  # see models/llama.py PRESETS
    checkpoint_path: str = ""  # empty = random init
    tokenizer_path: str = ""  # empty = byte tokenizer
    dtype: str = "bfloat16"
    seed: int = 0
    quant: str = ""  # weight-only quantized serving: "" | "int8" | "int4"
    quant_group: int = 0  # int4 rows of K per scale (0 = one scale per column)


@dataclass
class MeshConfig:
    """Device mesh axes. The port serves one card: ``build_app`` refuses a
    mesh that resolves to more than one device until the parallel plane is
    ported.

    Axis names follow the scaling-book convention: ``data`` (DP/batch),
    ``pipe`` (PP stages), ``model`` (TP), ``seq`` (SP/ring attention),
    ``expert`` (EP). A size of -1 means "absorb all remaining devices".
    """

    data: int = 1
    pipe: int = 1
    model: int = -1
    seq: int = 1
    expert: int = 1


@dataclass
class EngineConfig:
    """Inference engine + continuous-batching scheduler settings."""

    max_seqs: int = 64  # concurrent sequences
    page_size: int = 128  # tokens per KV page
    num_pages: int = 512  # total pages in the paged KV cache (page 0 = trash)
    max_seq_len: int = 8192
    prefill_chunk: int = 512  # chunked prefill granularity
    max_new_tokens: int = 1024
    temperature: float = 0.5
    top_p: float = 1.0
    top_k: int = 0
    watchdog_seconds: float = 100.0
    stream_flush_tokens: int = 1
    warmup_on_start: bool = True
    ring_prefill_min_tokens: int = 4096
    spec_tokens: int = 0
    prefix_cache: bool = True
    session_cache: bool = True
    session_cache_bytes: int = 256 << 20
    session_cache_disk_path: str = ""
    session_cache_disk_bytes: int = 4 << 30
    kv_quant: str = ""
    sp_mode: str = "ring"
    decode_loop_depth: int = 1
    retrieval_overlap: bool = True
    partial_hold_ttl_seconds: float = 30.0
    tool_streaming: bool = True
    # one packed ragged dispatch per scheduler iteration whenever prefill
    # work and in-flight decodes coexist (engine ragged_mixed_step)
    mixed_step: bool = True
    freerun_rounds: int = 1
    tp_overlap: bool = False
    tp_overlap_chunks: int = 4
    # inert in the port: the directory of XLA's persistent compilation
    # cache. The port builds its kernels from source at first use into
    # finchat_tpu_torch/build/<source hash>/, which is its only cache.
    compilation_cache_dir: str = ""
    breaker_threshold: int = 3
    breaker_max_rebuilds: int = 2
    preemption: bool = True
    request_deadline_seconds: float = 0.0
    edf_starvation_seconds: float = 10.0
    max_queue_depth: int = 0
    ring_prefill_chunk: int = 4096
    kv_sink_pages: int = 0
    kv_window_pages: int = 0


@dataclass
class EmbedConfig:
    """Embedding encoder (replaces the OpenAI embeddings API; not ported
    yet, so nothing in the port reads this section).

    ``checkpoint_path``: HF BertModel safetensors dir (e.g. bge-base-en-v1.5)
    loaded via checkpoints/bert_loader.py; empty = random weights (dev only).
    ``tokenizer_path``: matching HF tokenizer dir; empty = byte tokenizer.
    ``batch_size``: rows per device call during batch embedding/ingest.
    """

    preset: str = "bge-tiny"  # see embed/encoder.py EMBED_PRESETS
    checkpoint_path: str = ""
    tokenizer_path: str = ""
    batch_size: int = 64
    # cross-request embedding microbatcher (embed/batcher.py): concurrent
    # query embeds + ingest upserts coalesce into one bucket-padded
    # encode_batch dispatch. batch_window_ms = how long the first arrival
    # waits for company (0 = dispatch immediately, coalescing only what is
    # already queued); batch_max = texts per coalesced dispatch.
    batch_window_ms: float = 3.0
    batch_max: int = 32
    # int8 weight-only quantized encoder (embed/encoder.py
    # quantize_bert_params): the retrieval plane rides the same
    # QTensor machinery as the decoder; "" = full precision. Gated on
    # quantized-vs-fp32 top-k overlap >= 0.99. Also FINCHAT_EMBED_QUANT.
    quant: str = ""


@dataclass
class FleetConfig:
    """Engine replica fleet (serve/fleet.py).

    ``replicas`` > 1 stands up N engine replicas under one serving plane —
    each with its own scheduler, KV page pool, and session cache — behind a
    router that rendezvous-hashes the conversation's Kafka partition
    (io/kafka.py partition_for_key, the SAME hash the broker uses for
    key→partition placement) to a live replica, so a conversation's
    session-cache entries and prefix heads stay local and routing agrees
    with partition assignment by construction. Not ported yet:
    ``build_app`` refuses ``replicas`` > 1.
    """

    replicas: int = 1
    # breaker trips DRAIN the replica's live conversations to siblings
    # (preempt-to-host + session-cache handoff; streams continue
    # byte-identical on the adopter) instead of riding out the rebuild on
    # the tripped replica; a give-up replica is marked OUT, its routing
    # share reassigned, and the supervisor respawns it. False = every
    # replica recovers alone, the single-engine behavior.
    drain_on_trip: bool = True
    # supervisor: respawn (rebuild device state, re-register prompt heads)
    # a given-up replica in the background while the rest of the fleet
    # absorbs its load; False leaves it OUT until process restart
    respawn: bool = True
    respawn_backoff_seconds: float = 0.5
    supervisor_interval_seconds: float = 0.2
    # disaggregated serving (serve/disagg.py): comma-separated
    # per-replica roles, e.g. "prefill,decode,decode" — ``prefill``
    # replicas never own conversations (the router hashes over the
    # decode+mixed serving pool only); a serving replica routes each cold
    # turn's prompt prefill to the prefill pool and adopts the KV over the
    # drain-handoff wire format. "" = every replica ``mixed`` (the plain-fleet
    # behavior); a short list pads with ``mixed``. Also FINCHAT_FLEET_ROLES,
    # CLI --fleet-roles.
    roles: str = ""


@dataclass
class FabricConfig:
    """Cluster-wide warm-state fabric (engine/warm_fabric.py).

    With ``enabled`` and a ``path``, every replica's session cache shares
    ONE disk tier (instead of per-replica subdirectories) and a global
    RAM index, so any replica resumes any conversation warm and the
    shared prompt heads' prefill is paid once per fleet — later replicas
    and respawns restore the head KV from the fabric with one H2D
    scatter. The tier's byte budget reuses
    ``engine.session_cache_disk_bytes``. Not ported yet: ``build_app``
    refuses ``enabled``.
    """

    enabled: bool = False  # FINCHAT_FABRIC
    path: str = ""  # fabric directory; also FINCHAT_FABRIC_PATH, CLI --fabric-path


@dataclass
class JournalConfig:
    """Answered-message journal (io/journal.py).

    With ``path`` set, every ANSWERED ``message_id`` is appended to a
    checksummed journal and fsynced BEFORE its Kafka offset commits, and a
    restarted process replays the journal into the fleet-wide dedupe ring —
    closing the crash-redelivery double-answer window the in-memory ring
    alone leaves open. Failed/shed/timed-out ids are never journaled, so
    producer retries are reprocessed.
    """

    path: str = ""  # journal directory; "" = journal off. FINCHAT_JOURNAL_PATH
    # fsync each append before returning (the ordering guarantee relies on
    # it; turn off only for drills where torn tails are acceptable)
    fsync: bool = True  # FINCHAT_JOURNAL_FSYNC


@dataclass
class PodConfig:
    """Multi-host pod plane (serve/pod.py).

    With ``host_id`` set, this process is one HOST of a pod: its fleet is
    one failure domain, its Kafka consumer-group member owns a partition
    share (routing ≡ assignment), and a ``PodCoordinator`` runs a liaison
    channel to the peers — heartbeat for failure detection, session-byte
    transfer for cross-host warm resume. On a peer's death the survivors
    adopt its partitions (broker rebalance), replay exactly the inherited
    per-partition journals into the dedupe ring, and resume the dead
    host's conversations via the warm fabric or a liaison pull. Empty
    ``host_id`` = the plane entirely off: single-host behavior is
    bit-identical to the plain fleet. Not ported yet: ``build_app``
    refuses a ``host_id``.
    """

    host_id: str = ""  # this host's name in the pod; "" = pod plane off
    # peer table: "hostB=tcp:127.0.0.1:9710,hostC=inproc:hostC" — transport
    # is tcp:<host>:<port> or inproc:<name> (in-process registry, the
    # simulated-pod/test transport). "" = no liaison: heartbeat/transfer
    # off, fabric-or-cold resume only.
    peers: str = ""
    # this host's liaison listen address (same tcp:/inproc: syntax); "" =
    # serve nothing (peers can still be dialed)
    listen: str = ""
    heartbeat_interval_seconds: float = 0.5
    # consecutive missed heartbeats before a peer is declared dead and its
    # partitions adopted
    heartbeat_miss_threshold: int = 3
    transfer_timeout_seconds: float = 5.0
    # per-op retries on top of the first attempt (transfer only; a missed
    # heartbeat is itself the signal and never retries inline)
    transfer_retries: int = 2
    retry_backoff_seconds: float = 0.05
    # per-peer circuit breaker: consecutive liaison failures before the
    # peer's channel opens (calls fail fast), and how long until a
    # half-open probe is allowed through
    breaker_threshold: int = 3
    breaker_cooldown_seconds: float = 2.0


@dataclass
class ShutdownConfig:
    """Graceful SIGTERM drain (serve/app.py drain_and_stop)."""

    # how long in-flight streams may keep running after SIGTERM before the
    # stragglers are preempted to host (session bytes spilled, stream
    # failed with a retryable ``shutting_down`` error); also
    # FINCHAT_SHUTDOWN_DEADLINE_SECONDS
    deadline_seconds: float = 20.0


@dataclass
class TracingConfig:
    """End-to-end request tracing + anomaly flight recorder
    (utils/tracing.py; OBSERVABILITY.md)."""

    # record structured trace events (span marks, dispatch rows, fleet
    # moves) into the bounded per-process ring and serve
    # GET /debug/trace/<trace_id>; events stamp from host data only, so
    # the decode hot path pays < 2% with this on (bench --trace-overhead
    # gates it). Also FINCHAT_TRACING.
    enabled: bool = True
    # ring capacity in events — bounds tracing memory (~100 bytes/event);
    # the flight recorder dumps exactly this window on anomaly. Also
    # FINCHAT_TRACING_RING_EVENTS.
    ring_events: int = 65536
    # flight-recorder directory: on anomaly (breaker trip, watchdog fire,
    # shed, replica give-up, record quarantine, SIGTERM drain) the ring is
    # dumped to a checksummed file here, alongside the anomaly's own
    # event. "" = flight recorder off (events still ring-buffer). Also
    # FINCHAT_TRACING_FLIGHT_DIR, CLI --flight-dir.
    flight_dir: str = ""


@dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 8000


@dataclass
class AppConfig:
    kafka: KafkaConfig = field(default_factory=KafkaConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    vector: VectorConfig = field(default_factory=VectorConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    embed: EmbedConfig = field(default_factory=EmbedConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    fabric: FabricConfig = field(default_factory=FabricConfig)
    journal: JournalConfig = field(default_factory=JournalConfig)
    pod: PodConfig = field(default_factory=PodConfig)
    shutdown: ShutdownConfig = field(default_factory=ShutdownConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _apply_overrides(cfg: Any, overrides: dict[str, Any]) -> None:
    """Apply a {"section.key": value} or nested-dict override mapping."""
    for key, value in overrides.items():
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            if not hasattr(node, part):
                raise KeyError(f"unknown config key: {key!r}")
            node = getattr(node, part)
        leaf = parts[-1]
        if not hasattr(node, leaf):
            raise KeyError(f"unknown config key: {key!r}")
        if isinstance(value, dict) and dataclasses.is_dataclass(getattr(node, leaf)):
            _apply_overrides(getattr(node, leaf), {k: v for k, v in value.items()})
        else:
            setattr(node, leaf, value)


def load_config(
    config_file: str | None = None, overrides: dict[str, Any] | None = None
) -> AppConfig:
    """Build the config tree: defaults ← env vars ← JSON file ← overrides.

    Env names match the reference (``config.py:8-47``) so a reference
    deployment's ``.env`` drops in unchanged.
    """
    cfg = AppConfig()

    # --- env (reference-compatible names) ---
    cfg.kafka.bootstrap_servers = _env("KAFKA_SERVER")
    cfg.kafka.username = _env("KAFKA_USERNAME")
    cfg.kafka.password = _env("KAFKA_PASSWORD")
    cfg.store.mongodb_uri = _env("MONGODB_URI")
    cfg.vector.url = _env("QDRANT_URL")
    cfg.vector.api_key = _env("QDRANT_API_KEY")

    # --- env (new framework surface; every knob here is listed in the
    # README "Configuration reference" — finchat-lint R4 enforces the
    # three-way knob/env/README agreement) ---
    cfg.kafka.session_timeout_ms = _env_int(
        "FINCHAT_KAFKA_SESSION_TIMEOUT_MS", cfg.kafka.session_timeout_ms
    )
    cfg.kafka.client_id = _env("FINCHAT_KAFKA_CLIENT_ID", cfg.kafka.client_id)
    cfg.kafka.auto_offset_reset = _env(
        "FINCHAT_KAFKA_AUTO_OFFSET_RESET", cfg.kafka.auto_offset_reset
    )
    cfg.store.database_name = _env("FINCHAT_STORE_DB", cfg.store.database_name)
    cfg.model.dtype = _env("FINCHAT_DTYPE", cfg.model.dtype)
    cfg.model.seed = _env_int("FINCHAT_SEED", cfg.model.seed)
    cfg.mesh.data = _env_int("FINCHAT_MESH_DATA", cfg.mesh.data)
    cfg.mesh.pipe = _env_int("FINCHAT_MESH_PIPE", cfg.mesh.pipe)
    cfg.mesh.model = _env_int("FINCHAT_MESH_MODEL", cfg.mesh.model)
    cfg.mesh.seq = _env_int("FINCHAT_MESH_SEQ", cfg.mesh.seq)
    cfg.mesh.expert = _env_int("FINCHAT_MESH_EXPERT", cfg.mesh.expert)
    cfg.engine.page_size = _env_int("FINCHAT_PAGE_SIZE", cfg.engine.page_size)
    cfg.engine.num_pages = _env_int("FINCHAT_NUM_PAGES", cfg.engine.num_pages)
    cfg.engine.max_seq_len = _env_int("FINCHAT_MAX_SEQ_LEN", cfg.engine.max_seq_len)
    cfg.engine.prefill_chunk = _env_int(
        "FINCHAT_PREFILL_CHUNK", cfg.engine.prefill_chunk
    )
    cfg.engine.max_new_tokens = _env_int(
        "FINCHAT_MAX_NEW_TOKENS", cfg.engine.max_new_tokens
    )
    cfg.engine.temperature = _env_float("FINCHAT_TEMPERATURE", cfg.engine.temperature)
    cfg.engine.top_p = _env_float("FINCHAT_TOP_P", cfg.engine.top_p)
    cfg.engine.top_k = _env_int("FINCHAT_TOP_K", cfg.engine.top_k)
    cfg.engine.watchdog_seconds = _env_float(
        "FINCHAT_WATCHDOG_SECONDS", cfg.engine.watchdog_seconds
    )
    cfg.engine.stream_flush_tokens = _env_int(
        "FINCHAT_STREAM_FLUSH_TOKENS", cfg.engine.stream_flush_tokens
    )
    cfg.engine.edf_starvation_seconds = _env_float(
        "FINCHAT_EDF_STARVATION_SECONDS", cfg.engine.edf_starvation_seconds
    )
    cfg.embed.preset = _env("FINCHAT_EMBED_PRESET", cfg.embed.preset)
    cfg.embed.batch_size = _env_int("FINCHAT_EMBED_BATCH_SIZE", cfg.embed.batch_size)
    cfg.fleet.respawn_backoff_seconds = _env_float(
        "FINCHAT_FLEET_RESPAWN_BACKOFF_SECONDS", cfg.fleet.respawn_backoff_seconds
    )
    cfg.fleet.supervisor_interval_seconds = _env_float(
        "FINCHAT_FLEET_SUPERVISOR_INTERVAL_SECONDS",
        cfg.fleet.supervisor_interval_seconds,
    )
    cfg.serve.host = _env("FINCHAT_HOST", cfg.serve.host)
    cfg.kafka.backend = _env("FINCHAT_KAFKA_BACKEND", cfg.kafka.backend)
    cfg.kafka.commit_after_process = _env_bool(
        "FINCHAT_KAFKA_COMMIT_AFTER_PROCESS", cfg.kafka.commit_after_process
    )
    cfg.kafka.num_partitions = _env_int(
        "FINCHAT_KAFKA_NUM_PARTITIONS", cfg.kafka.num_partitions
    )
    cfg.store.backend = _env("FINCHAT_STORE_BACKEND", cfg.store.backend)
    cfg.vector.persist_path = _env("FINCHAT_VECTOR_PERSIST", cfg.vector.persist_path)
    cfg.model.preset = _env("FINCHAT_MODEL_PRESET", cfg.model.preset)
    cfg.model.checkpoint_path = _env("FINCHAT_CHECKPOINT", cfg.model.checkpoint_path)
    cfg.model.tokenizer_path = _env("FINCHAT_TOKENIZER", cfg.model.tokenizer_path)
    cfg.model.quant = _env("FINCHAT_QUANT", cfg.model.quant)
    cfg.model.quant_group = _env_int("FINCHAT_QUANT_GROUP", cfg.model.quant_group)
    cfg.embed.quant = _env("FINCHAT_EMBED_QUANT", cfg.embed.quant)
    cfg.embed.checkpoint_path = _env("FINCHAT_EMBED_CHECKPOINT", cfg.embed.checkpoint_path)
    cfg.embed.tokenizer_path = _env("FINCHAT_EMBED_TOKENIZER", cfg.embed.tokenizer_path)
    cfg.embed.batch_window_ms = _env_float(
        "FINCHAT_EMBED_BATCH_WINDOW_MS", cfg.embed.batch_window_ms
    )
    cfg.embed.batch_max = _env_int("FINCHAT_EMBED_BATCH_MAX", cfg.embed.batch_max)
    cfg.engine.max_seqs = _env_int("FINCHAT_MAX_SEQS", cfg.engine.max_seqs)
    cfg.engine.warmup_on_start = _env_bool("FINCHAT_WARMUP", cfg.engine.warmup_on_start)
    cfg.engine.ring_prefill_min_tokens = _env_int(
        "FINCHAT_RING_PREFILL_MIN", cfg.engine.ring_prefill_min_tokens
    )
    cfg.engine.spec_tokens = _env_int("FINCHAT_SPEC_TOKENS", cfg.engine.spec_tokens)
    cfg.engine.decode_loop_depth = _env_int(
        "FINCHAT_DECODE_LOOP_DEPTH", cfg.engine.decode_loop_depth
    )
    cfg.engine.ring_prefill_chunk = _env_int(
        "FINCHAT_RING_PREFILL_CHUNK", cfg.engine.ring_prefill_chunk
    )
    cfg.engine.kv_sink_pages = _env_int(
        "FINCHAT_KV_SINK_PAGES", cfg.engine.kv_sink_pages
    )
    cfg.engine.kv_window_pages = _env_int(
        "FINCHAT_KV_WINDOW_PAGES", cfg.engine.kv_window_pages
    )
    cfg.engine.sp_mode = _env("FINCHAT_SP_MODE", cfg.engine.sp_mode)
    cfg.engine.kv_quant = _env("FINCHAT_KV_QUANT", cfg.engine.kv_quant)
    cfg.engine.prefix_cache = _env_bool("FINCHAT_PREFIX_CACHE", cfg.engine.prefix_cache)
    cfg.engine.session_cache = _env_bool("FINCHAT_SESSION_CACHE", cfg.engine.session_cache)
    cfg.engine.session_cache_bytes = _env_int(
        "FINCHAT_SESSION_CACHE_BYTES", cfg.engine.session_cache_bytes
    )
    cfg.engine.session_cache_disk_path = _env(
        "FINCHAT_SESSION_CACHE_DISK", cfg.engine.session_cache_disk_path
    )
    cfg.engine.session_cache_disk_bytes = _env_int(
        "FINCHAT_SESSION_CACHE_DISK_BYTES", cfg.engine.session_cache_disk_bytes
    )
    cfg.journal.path = _env("FINCHAT_JOURNAL_PATH", cfg.journal.path)
    cfg.journal.fsync = _env_bool("FINCHAT_JOURNAL_FSYNC", cfg.journal.fsync)
    cfg.pod.host_id = _env("FINCHAT_POD_HOST_ID", cfg.pod.host_id)
    cfg.pod.peers = _env("FINCHAT_POD_PEERS", cfg.pod.peers)
    cfg.pod.listen = _env("FINCHAT_POD_LISTEN", cfg.pod.listen)
    cfg.pod.heartbeat_interval_seconds = _env_float(
        "FINCHAT_POD_HEARTBEAT_INTERVAL_SECONDS",
        cfg.pod.heartbeat_interval_seconds,
    )
    cfg.pod.heartbeat_miss_threshold = _env_int(
        "FINCHAT_POD_HEARTBEAT_MISS_THRESHOLD",
        cfg.pod.heartbeat_miss_threshold,
    )
    cfg.pod.transfer_timeout_seconds = _env_float(
        "FINCHAT_POD_TRANSFER_TIMEOUT_SECONDS",
        cfg.pod.transfer_timeout_seconds,
    )
    cfg.pod.transfer_retries = _env_int(
        "FINCHAT_POD_TRANSFER_RETRIES", cfg.pod.transfer_retries
    )
    cfg.pod.retry_backoff_seconds = _env_float(
        "FINCHAT_POD_RETRY_BACKOFF_SECONDS", cfg.pod.retry_backoff_seconds
    )
    cfg.pod.breaker_threshold = _env_int(
        "FINCHAT_POD_BREAKER_THRESHOLD", cfg.pod.breaker_threshold
    )
    cfg.pod.breaker_cooldown_seconds = _env_float(
        "FINCHAT_POD_BREAKER_COOLDOWN_SECONDS",
        cfg.pod.breaker_cooldown_seconds,
    )
    cfg.shutdown.deadline_seconds = _env_float(
        "FINCHAT_SHUTDOWN_DEADLINE_SECONDS", cfg.shutdown.deadline_seconds
    )
    cfg.kafka.offsets_dir = _env("FINCHAT_KAFKA_OFFSETS_DIR", cfg.kafka.offsets_dir)
    cfg.tracing.enabled = _env_bool("FINCHAT_TRACING", cfg.tracing.enabled)
    cfg.tracing.ring_events = _env_int(
        "FINCHAT_TRACING_RING_EVENTS", cfg.tracing.ring_events
    )
    cfg.tracing.flight_dir = _env(
        "FINCHAT_TRACING_FLIGHT_DIR", cfg.tracing.flight_dir
    )
    cfg.engine.retrieval_overlap = _env_bool(
        "FINCHAT_RETRIEVAL_OVERLAP", cfg.engine.retrieval_overlap
    )
    cfg.engine.partial_hold_ttl_seconds = _env_float(
        "FINCHAT_PARTIAL_HOLD_TTL_SECONDS", cfg.engine.partial_hold_ttl_seconds
    )
    cfg.engine.tool_streaming = _env_bool(
        "FINCHAT_TOOL_STREAMING", cfg.engine.tool_streaming
    )
    cfg.engine.mixed_step = _env_bool("FINCHAT_MIXED_STEP", cfg.engine.mixed_step)
    cfg.engine.freerun_rounds = _env_int(
        "FINCHAT_FREERUN_ROUNDS", cfg.engine.freerun_rounds
    )
    cfg.engine.tp_overlap = _env_bool("FINCHAT_TP_OVERLAP", cfg.engine.tp_overlap)
    cfg.engine.tp_overlap_chunks = _env_int(
        "FINCHAT_TP_OVERLAP_CHUNKS", cfg.engine.tp_overlap_chunks
    )
    cfg.engine.compilation_cache_dir = _env(
        "FINCHAT_COMPILATION_CACHE_DIR", cfg.engine.compilation_cache_dir
    )
    cfg.engine.breaker_threshold = _env_int(
        "FINCHAT_BREAKER_THRESHOLD", cfg.engine.breaker_threshold
    )
    cfg.engine.breaker_max_rebuilds = _env_int(
        "FINCHAT_BREAKER_MAX_REBUILDS", cfg.engine.breaker_max_rebuilds
    )
    cfg.engine.preemption = _env_bool("FINCHAT_PREEMPTION", cfg.engine.preemption)
    cfg.engine.request_deadline_seconds = _env_float(
        "FINCHAT_REQUEST_DEADLINE_SECONDS", cfg.engine.request_deadline_seconds
    )
    cfg.engine.max_queue_depth = _env_int(
        "FINCHAT_MAX_QUEUE_DEPTH", cfg.engine.max_queue_depth
    )
    cfg.fleet.replicas = _env_int("FINCHAT_FLEET_REPLICAS", cfg.fleet.replicas)
    cfg.fleet.drain_on_trip = _env_bool(
        "FINCHAT_FLEET_DRAIN_ON_TRIP", cfg.fleet.drain_on_trip
    )
    cfg.fleet.respawn = _env_bool("FINCHAT_FLEET_RESPAWN", cfg.fleet.respawn)
    cfg.fleet.roles = _env("FINCHAT_FLEET_ROLES", cfg.fleet.roles)
    cfg.fabric.enabled = _env_bool("FINCHAT_FABRIC", cfg.fabric.enabled)
    cfg.fabric.path = _env("FINCHAT_FABRIC_PATH", cfg.fabric.path)
    cfg.serve.port = _env_int("FINCHAT_PORT", cfg.serve.port)

    # --- optional JSON config file ---
    if config_file:
        with open(config_file) as f:
            _apply_overrides(cfg, json.load(f))

    # --- explicit overrides win ---
    if overrides:
        _apply_overrides(cfg, overrides)

    # memory-broker committed offsets default into the journal dir (one
    # durability directory; one durability directory) — after overrides, so a
    # CLI/file journal path carries the default along
    if not cfg.kafka.offsets_dir and cfg.journal.path:
        cfg.kafka.offsets_dir = cfg.journal.path

    return cfg
