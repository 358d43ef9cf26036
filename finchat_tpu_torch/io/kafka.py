"""Kafka transport (own copy of the JAX package's ``io/kafka.py``).

The reference client's API: ``setup_consumer`` / ``produce_message`` /
``produce_error_message`` / ``poll_message`` / ``close``, with its QoS
split (response chunks are fire-and-forget, error chunks are flushed) and
its consumer settings (45 s session timeout, ``latest`` offset reset, group
``message_consumer``).

Two backends:

- ``InMemoryBroker``: an in-process broker with Kafka's semantics:
  partitions, key -> partition by CRC32 (so a conversation's chunks stay
  ordered), consumer groups with round-robin assignment over the sorted
  member ids, committed offsets (persisted to ``offsets_dir`` when given),
  producer timestamps, and manual-commit positions
  (``kafka.commit_after_process``): poll advances the position while the
  committed offset moves only at ``commit_offset``, so a crash mid-message
  redelivers it when the group re-forms. ``FaultInjection`` adds drop and
  poison hooks on produce for tests.
- confluent-kafka (librdkafka), used when ``kafka.backend == "confluent"``;
  imported when such a client is built, not before.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

from finchat_tpu_torch.utils.config import GROUP_ID, USER_MESSAGE_TOPIC, KafkaConfig
from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.metrics import METRICS

logger = get_logger(__name__)

DEFAULT_NUM_PARTITIONS = 4


def partition_for_key(key: str | None, num_partitions: int = DEFAULT_NUM_PARTITIONS) -> int:
    """THE key→partition placement function: CRC32 of the message key mod
    the partition count. One definition shared by the memory broker's
    produce path and the fleet router (serve/fleet.py), so conversation→
    replica routing is aligned with Kafka partition assignment BY
    CONSTRUCTION — every conversation of one partition routes to one
    replica, and a replica's routing share is exactly a set of partitions
    a consumer-group assignment could mirror. The disagg coordinator
    (serve/disagg.py) reuses it a third time for prefill-POOL placement,
    so a conversation's cold turns keep landing on the same prefill
    replica and its shared-head/session state stays warm between turns.

    CAVEAT (confluent backend): CRC32 is librdkafka's ``consistent``
    partitioner, NOT the Java client's default (murmur2) — messages
    produced by Java/KStreams services land on murmur2 partitions, which
    silently breaks the routing≡assignment alignment (affinity degrades
    to permanent cold resumes; nothing is incorrect, just slow). Either
    configure upstream Java producers with a CRC32-compatible
    partitioner, or accept partition-level affinity only for traffic
    produced through clients using ``consistent``."""
    if key is None:
        return 0
    return zlib.crc32(key.encode()) % num_partitions


class Message:
    """Consumer record with the confluent-kafka ``Message`` read surface the
    app uses: ``value()`` / ``key()`` / ``topic()`` / ``error()``."""

    def __init__(self, topic: str, key: str | None, value: bytes, offset: int = -1,
                 partition: int = 0, timestamp_ms: int | None = None):
        self._topic = topic
        self._key = key
        self._value = value
        self._offset = offset
        self._partition = partition
        self._timestamp_ms = int(time.time() * 1000) if timestamp_ms is None else timestamp_ms

    def value(self) -> bytes:
        return self._value

    def key(self) -> bytes | None:
        # bytes, matching librdkafka's Message.key(), so code developed
        # against the memory backend behaves identically on confluent.
        return self._key.encode() if isinstance(self._key, str) else self._key

    def topic(self) -> str:
        return self._topic

    def offset(self) -> int:
        return self._offset

    def partition(self) -> int:
        return self._partition

    def timestamp(self) -> tuple[int, int]:
        """(timestamp_type, ms) matching librdkafka's Message.timestamp()
        — type 1 is TIMESTAMP_CREATE_TIME (producer-stamped). The serving
        layer anchors per-request deadlines here (message arrival + the
        configured allowance), so queueing time counts against the
        deadline the way a client experiences it."""
        return (1, self._timestamp_ms)

    def error(self) -> None:
        return None


@dataclass
class FaultInjection:
    """Test-harness fault hooks on the memory broker's produce path."""

    drop_produce: Callable[[str, dict[str, Any]], bool] | None = None
    poison_produce: Callable[[str, bytes], bytes] | None = None


class _PartitionLog:
    def __init__(self) -> None:
        self.records: list[Message] = []


class _GroupState:
    def __init__(self) -> None:
        self.members: list[str] = []
        self.subscriptions: dict[str, list[str]] = {}  # member -> topics
        # COMMITTED offsets — what a (re)joining consumer resumes from
        self.offsets: dict[tuple[str, int], int] = {}  # (topic, partition) -> next offset
        # consumption positions — where poll reads next. Auto-commit mode
        # keeps them locked to ``offsets``; manual-commit mode (at-least-
        # once, kafka.commit_after_process) advances positions at poll but
        # offsets only at commit, so a consumer that crashes mid-message
        # redelivers everything uncommitted when the group re-forms.
        self.positions: dict[tuple[str, int], int] = {}


class InMemoryBroker:
    """In-process broker: topics × partitions, consumer groups, committed
    offsets. Thread-safe; shared by all clients in a process.

    ``offsets_dir`` (defaults to the journal dir via
    KafkaConfig.offsets_dir): committed group offsets persist to
    ``kafka_offsets.json`` there, and a FRESH broker instance loads them
    at construction — so a restart drill that re-produces the same
    records rewinds to the committed watermark exactly like a rejoining
    real consumer group, redelivering only the uncommitted tail. A
    persisted offset beyond a (shorter) fresh log warns and clamps."""

    OFFSETS_FILENAME = "kafka_offsets.json"

    def __init__(self, num_partitions: int = DEFAULT_NUM_PARTITIONS,
                 offsets_dir: str | None = None):
        self.num_partitions = num_partitions
        self._lock = threading.Lock()
        self._topics: dict[str, list[_PartitionLog]] = {}
        self._groups: dict[str, _GroupState] = {}
        self.faults = FaultInjection()
        self._offsets_path = None
        # group -> {"topic:partition": committed next offset}
        self._persisted: dict[str, dict[str, int]] = {}
        if offsets_dir:
            import pathlib

            d = pathlib.Path(offsets_dir)
            d.mkdir(parents=True, exist_ok=True)
            self._offsets_path = d / self.OFFSETS_FILENAME
            try:
                if self._offsets_path.exists():
                    self._persisted = json.loads(self._offsets_path.read_text())
                    logger.info("kafka: loaded persisted committed offsets "
                                "from %s", self._offsets_path)
            except Exception as e:
                logger.warning("kafka: persisted offsets at %s unreadable "
                               "(%s); starting from scratch",
                               self._offsets_path, e)
                self._persisted = {}

    def _partition_for(self, key: str | None) -> int:
        return partition_for_key(key, self.num_partitions)

    def _ensure_topic(self, topic: str) -> list[_PartitionLog]:
        if topic not in self._topics:
            self._topics[topic] = [_PartitionLog() for _ in range(self.num_partitions)]
        return self._topics[topic]

    def produce(self, topic: str, key: str | None, value: bytes) -> None:
        with self._lock:
            logs = self._ensure_topic(topic)
            part = self._partition_for(key)
            log = logs[part]
            log.records.append(Message(topic, key, value, offset=len(log.records), partition=part))

    def join_group(self, group_id: str, member_id: str, topics: list[str], offset_reset: str) -> None:
        with self._lock:
            group = self._groups.setdefault(group_id, _GroupState())
            if member_id not in group.members:
                group.members.append(member_id)
            group.subscriptions[member_id] = list(topics)
            for topic in topics:
                logs = self._ensure_topic(topic)
                for part, log in enumerate(logs):
                    tp = (topic, part)
                    if tp not in group.offsets:
                        saved = self._persisted.get(group_id, {}).get(
                            f"{topic}:{part}"
                        )
                        if saved is not None:
                            # restart drill: a fresh broker with
                            # persisted offsets resumes at the committed
                            # watermark, like a rejoining consumer group
                            if saved > len(log.records):
                                logger.warning(
                                    "kafka: persisted committed offset %d "
                                    "for %s[%d] is beyond the log (%d "
                                    "records); clamping — the fresh broker "
                                    "holds fewer records than the one that "
                                    "committed", saved, topic, part,
                                    len(log.records),
                                )
                                saved = len(log.records)
                            group.offsets[tp] = saved
                        else:
                            group.offsets[tp] = (
                                len(log.records) if offset_reset == "latest" else 0
                            )
                    # a (re)join rewinds the position to the committed
                    # offset — the rebalance semantics that make manual
                    # commit at-least-once (uncommitted records redeliver)
                    group.positions[tp] = group.offsets[tp]

    def leave_group(self, group_id: str, member_id: str) -> None:
        with self._lock:
            group = self._groups.get(group_id)
            if group and member_id in group.members:
                group.members.remove(member_id)
                group.subscriptions.pop(member_id, None)

    def _assignment(self, group: _GroupState, member_id: str, topics: list[str]) -> list[tuple[str, int]]:
        """Round-robin partition assignment, per topic, among the members
        actually subscribed to that topic (so mixed-subscription groups
        leave no partition orphaned). Positions are taken over the SORTED
        member ids, not join order, so the mapping is a pure function of
        the member set — a host that drops out and rejoins under its old
        member id gets back exactly the partitions it had (the pod
        layer's rejoin contract, serve/pod.py)."""
        out = []
        for topic in topics:
            subscribers = sorted(
                m for m in group.members if topic in group.subscriptions.get(m, ())
            )
            if member_id not in subscribers:
                continue
            idx = subscribers.index(member_id)
            n = len(subscribers)
            for part in range(self.num_partitions):
                if part % n == idx:
                    out.append((topic, part))
        return out

    def poll(self, group_id: str, member_id: str, topics: list[str],
             auto_commit: bool = True) -> Message | None:
        with self._lock:
            group = self._groups.get(group_id)
            if group is None or member_id not in group.members:
                return None
            for topic, part in self._assignment(group, member_id, topics):
                log = self._topics[topic][part]
                tp = (topic, part)
                pos = group.positions.get(tp, group.offsets.get(tp, 0))
                if pos < len(log.records):
                    group.positions[tp] = pos + 1
                    if auto_commit:  # at-most-once (reference parity)
                        group.offsets[tp] = pos + 1
                    return log.records[pos]
            return None

    def commit(self, group_id: str, topic: str, partition: int, next_offset: int) -> None:
        """Commit ``next_offset`` as the resume point for a partition
        (manual-commit mode). Monotonic: a late commit for an earlier
        offset never rewinds a later one."""
        with self._lock:
            group = self._groups.get(group_id)
            if group is None:
                return
            tp = (topic, partition)
            group.offsets[tp] = max(group.offsets.get(tp, 0), next_offset)
            if self._offsets_path is not None:
                self._persisted.setdefault(group_id, {})[
                    f"{topic}:{partition}"
                ] = group.offsets[tp]
                self._persist_offsets()

    def _persist_offsets(self) -> None:
        """Atomic write-rename of the committed-offsets map (lock held).
        Best-effort: a failed write costs redelivery depth on the next
        restart, never correctness (the journal dedupes answered ids).

        Deliberately no fsync: this runs on
        the event loop once per watermark advance, and a per-commit fsync
        there is exactly the blocking class the lint exists for. The
        atomic rename survives a process kill — the restart-drill
        contract; an OS crash can lose the latest watermark, which costs
        only redelivery depth that the answered-id journal dedupes."""
        tmp = self._offsets_path.with_suffix(".tmp")
        try:
            import os

            # ~100-byte JSON, atomic tmp-rename; bounded and rare relative
            # to the journal's per-answer fsync that precedes every commit
            with open(tmp, "w") as f:  # finchat-lint: disable=event-loop-blocking -- memory-broker drill path only; ~100-byte atomic rewrite, no fsync (see docstring)
                f.write(json.dumps(self._persisted))
                f.flush()
            os.replace(tmp, self._offsets_path)
        except Exception as e:
            logger.error("kafka: persisting committed offsets failed: %s", e)

    # --- test/introspection helpers -------------------------------------
    def drain(self, topic: str) -> list[Message]:
        """Read every record on a topic (all partitions, produce order per
        partition). Test-only helper."""
        with self._lock:
            logs = self._topics.get(topic, [])
            return [rec for log in logs for rec in log.records]


_PROCESS_BROKER: InMemoryBroker | None = None
_PROCESS_BROKER_LOCK = threading.Lock()


def default_broker(num_partitions: int = DEFAULT_NUM_PARTITIONS,
                   offsets_dir: str | None = None) -> InMemoryBroker:
    """Process-wide shared broker for the memory backend, so independently
    constructed producers and consumers in one process see each other.
    ``num_partitions`` / ``offsets_dir`` apply only when THIS call creates
    the broker (kafka.num_partitions / kafka.offsets_dir, via the first
    KafkaClient); later callers share it as-is — a partition-count
    mismatch warns at client construction."""
    global _PROCESS_BROKER
    with _PROCESS_BROKER_LOCK:
        if _PROCESS_BROKER is None:
            _PROCESS_BROKER = InMemoryBroker(num_partitions, offsets_dir=offsets_dir)
        return _PROCESS_BROKER


class KafkaClient:
    """Reference-compatible client (kafka_client.py) over either backend."""

    def __init__(self, config: KafkaConfig | None = None, broker: InMemoryBroker | None = None):
        self.config = config or KafkaConfig()
        self._consumer_ready = False
        self._topics: list[str] = []
        self._member_id = f"member-{uuid.uuid4().hex[:12]}"
        # at-least-once: poll does NOT advance the committed offset; the
        # app calls commit_message after the watchdog-wrapped handler
        # completes (serve/app.py)
        self._manual_commit = bool(self.config.commit_after_process)

        self._ck = None  # the confluent_kafka module, on that backend
        if self.config.backend == "confluent":
            try:
                import confluent_kafka  # type: ignore
            except ImportError:
                raise RuntimeError(
                    "kafka.backend=confluent but confluent-kafka is not installed") from None
            self._ck = confluent_kafka
            self._broker = None
            self._producer = confluent_kafka.Producer(self.config.librdkafka_config())
            self._consumer = None
        else:
            self._broker = broker or default_broker(
                self.config.num_partitions,
                offsets_dir=self.config.offsets_dir or None,
            )
            self._producer = None
            self._consumer = None
            if self._broker.num_partitions != self.config.num_partitions:
                logger.warning(
                    "kafka: broker has %d partitions but kafka.num_partitions"
                    " is %d; using the broker's count for routing",
                    self._broker.num_partitions, self.config.num_partitions,
                )

    # --- consumer -------------------------------------------------------
    def setup_consumer(self, topics: list[str] | None = None) -> None:
        self._topics = topics or [USER_MESSAGE_TOPIC]
        if self._broker is not None:
            self._broker.join_group(GROUP_ID, self._member_id, self._topics, self.config.auto_offset_reset)
        else:  # pragma: no cover - needs librdkafka
            consumer_config = {
                **self.config.librdkafka_config(),
                "session.timeout.ms": str(self.config.session_timeout_ms),
                "client.id": self.config.client_id,
                "group.id": GROUP_ID,
                "auto.offset.reset": self.config.auto_offset_reset,
            }
            if self._manual_commit:
                consumer_config["enable.auto.commit"] = "false"
            self._consumer = self._ck.Consumer(consumer_config)
            self._consumer.subscribe(self._topics)
        self._consumer_ready = True
        logger.info("Kafka consumer started, waiting for messages...")

    def poll_message(self) -> Message | None:
        if not self._consumer_ready:
            logger.error("Kafka consumer is not initialized.")
            return None
        try:
            if self._broker is not None:
                return self._broker.poll(
                    GROUP_ID, self._member_id, self._topics,
                    auto_commit=not self._manual_commit,
                )
            msg = self._consumer.poll(0.1)  # pragma: no cover
            if msg is None or msg.error():
                if msg is not None:
                    logger.error("Consumer error: %s", msg.error())
                return None
            return msg
        except Exception as e:
            logger.error("Error in message consumption: %s", e)
            return None

    @property
    def member_id(self) -> str:
        """This consumer's group-member id — the unit the broker assigns
        partitions to and the handle a pod-layer eviction removes. One
        host's App is one member; its partition share IS its routing
        share (routing ≡ assignment)."""
        return self._member_id

    def assignment(self) -> list[tuple[str, int]]:
        """The (topic, partition) pairs currently assigned to THIS member
        — the pod coordinator diffs this across a rebalance to find the
        partitions a host just inherited (and therefore which per-
        partition journals to replay into its dedupe ring). Empty before
        ``setup_consumer`` and, on the confluent backend, until the first
        poll completes the group join."""
        if not self._consumer_ready:
            return []
        if self._broker is not None:
            with self._broker._lock:
                group = self._broker._groups.get(GROUP_ID)
                if group is None:
                    return []
                return self._broker._assignment(group, self._member_id,
                                                self._topics)
        if self._consumer is not None:  # pragma: no cover - needs librdkafka
            return [(tp.topic, tp.partition)
                    for tp in self._consumer.assignment()]
        return []

    @property
    def num_partitions(self) -> int:
        """Partitions per topic — the fleet router's routing-unit count.
        The memory broker reports its exact count; the confluent backend
        trusts ``kafka.num_partitions``, which MUST match how the real
        topics were created or the routing ≡ partition-assignment
        alignment silently breaks (see KafkaConfig.num_partitions)."""
        return (self._broker.num_partitions if self._broker is not None
                else self.config.num_partitions)

    def partition_for(self, key: str) -> int:
        """The partition this client's broker places ``key`` on — the
        routing unit the fleet router hashes to a replica."""
        return partition_for_key(key, self.num_partitions)

    def commit_offset(self, topic: str, partition: int, next_offset: int) -> None:
        """Commit a partition's resume offset (manual-commit mode; no-op
        otherwise). The app calls this with its contiguous-completion
        watermark — never a bare message offset, which would implicitly
        commit every EARLIER in-flight message on the partition too
        (serve/app.py _note_message_done)."""
        if not self._manual_commit:
            return
        if self._broker is not None:
            self._broker.commit(GROUP_ID, topic, partition, next_offset)
        elif self._consumer is not None:  # pragma: no cover - needs librdkafka
            self._consumer.commit(
                offsets=[self._ck.TopicPartition(topic, partition, next_offset)],
                asynchronous=False,
            )
        METRICS.inc("finchat_kafka_commits_total")

    # --- producer -------------------------------------------------------
    def _produce_raw(self, topic: str, key: str, value: dict[str, Any]) -> None:
        payload = json.dumps(value).encode()
        if self._broker is not None:
            faults = self._broker.faults
            if faults.drop_produce and faults.drop_produce(topic, value):
                logger.warning("fault injection: dropped produce to %s", topic)
                return
            if faults.poison_produce:
                payload = faults.poison_produce(topic, payload)
            self._broker.produce(topic, key, payload)
        else:  # pragma: no cover
            self._producer.produce(topic, key=key, value=payload)

    def produce_message(self, topic: str, key: str, value: dict[str, Any]) -> None:
        """Fire-and-forget produce (reference kafka_client.py:24-31)."""
        try:
            self._produce_raw(topic, key, value)
            if self._producer is not None:  # pragma: no cover
                self._producer.poll(0)
            METRICS.inc("finchat_kafka_produced_total")
            logger.debug("Queued message to Kafka topic %s", topic)
        except Exception as e:
            logger.error("Error producing message to Kafka: %s", e)
            raise

    def produce_error_message(self, topic: str, key: str, value: dict[str, Any]) -> None:
        """Flushed produce — error delivery is guaranteed (kafka_client.py:33-40)."""
        try:
            self._produce_raw(topic, key, value)
            if self._producer is not None:  # pragma: no cover
                self._producer.flush()
            METRICS.inc("finchat_kafka_errors_produced_total")
            logger.debug("Queued error message to Kafka topic %s", topic)
        except Exception as e:
            logger.error("Failed to send error message to Kafka: %s", e)
            raise

    def close(self) -> None:
        if self._broker is not None and self._consumer_ready:
            self._broker.leave_group(GROUP_ID, self._member_id)
        if self._consumer is not None:  # pragma: no cover
            self._consumer.close()
        if self._producer is not None:  # pragma: no cover
            self._producer.flush()
