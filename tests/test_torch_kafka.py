"""The port's Kafka transport (``io/kafka.py``) against the JAX package's:
``partition_for_key`` over keys, group assignment over member lists, the
same poll / commit / ``FaultInjection`` traces from the same scripted
scenario, and persisted offset files byte-equal, each package's broker
reading the other's (after tests/test_kafka.py and the broker cases of
tests/test_durability.py)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import finchat_tpu.io.kafka as jkafka  # noqa: E402
import finchat_tpu.utils.config as jcfg  # noqa: E402
import finchat_tpu_torch.io.kafka as tkafka  # noqa: E402
import finchat_tpu_torch.utils.config as tcfg  # noqa: E402

SIDES = {"port": SimpleNamespace(kafka=tkafka, cfg=tcfg),
         "jax": SimpleNamespace(kafka=jkafka, cfg=jcfg)}
TOPIC = "user_message"


def _keys(seed: int, n: int = 300) -> list:
    rng = np.random.default_rng(seed)
    keys = [None, "", "conv-1", "ü-✓", "a" * 500]
    for _ in range(n):
        k = int(rng.integers(1, 40))
        keys.append("".join(chr(int(c)) for c in rng.integers(32, 0x2FFF, size=k)))
    return keys


@pytest.mark.parametrize("parts", [1, 3, 4, 8, 64])
def test_partition_for_key_equal(parts):
    for key in _keys(parts):
        assert tkafka.partition_for_key(key, parts) == jkafka.partition_for_key(key, parts)
    assert tkafka.DEFAULT_NUM_PARTITIONS == jkafka.DEFAULT_NUM_PARTITIONS


def _assignments(side, members: list[str], subs: dict, parts: int) -> dict:
    broker = side.kafka.InMemoryBroker(num_partitions=parts)
    for m in members:
        broker.join_group("g", m, subs.get(m, [TOPIC]), "earliest")
    group = broker._groups["g"]
    return {m: broker._assignment(group, m, subs.get(m, [TOPIC, "other"])) for m in members}


@pytest.mark.parametrize("seed", range(6))
def test_group_assignment_equal(seed):
    rng = np.random.default_rng(seed)
    members = [f"member-{int(x):04x}" for x in rng.integers(0, 65536, size=int(rng.integers(1, 7)))]
    subs = {m: [TOPIC, "other"] if rng.random() < 0.5 else [TOPIC] for m in members}
    parts = int(rng.integers(1, 9))
    got = _assignments(SIDES["port"], members, subs, parts)
    assert got == _assignments(SIDES["jax"], members, subs, parts)
    # every partition of the topic has one owner
    owned = sorted(p for a in got.values() for t, p in a if t == TOPIC)
    assert owned == list(range(parts))


def _script(side, tmp_path=None) -> list:
    """One scripted run: produce, join, poll, commit (manual and auto),
    close and rejoin, with drop and poison faults. Returns what the client
    saw, message by message."""
    K, C = side.kafka, side.cfg
    broker = K.InMemoryBroker(num_partitions=4,
                              offsets_dir=str(tmp_path) if tmp_path else None)
    log = []

    def seen(m):
        log.append(None if m is None else (m.topic(), m.partition(), m.offset(), m.key(),
                                            m.value(), m.timestamp()[0], m.error()))

    producer = K.KafkaClient(C.KafkaConfig(backend="memory"), broker=broker)
    producer.produce_message(TOPIC, "k0", {"old": True})  # before the join: latest skips it
    manual = K.KafkaClient(C.KafkaConfig(backend="memory", commit_after_process=True),
                           broker=broker)
    manual.setup_consumer([TOPIC])
    seen(manual.poll_message())
    for i in range(12):
        producer.produce_message(TOPIC, f"conv-{i % 5}", {"i": i, "conversation_id": f"conv-{i % 5}"})
    polled = []
    while (m := manual.poll_message()) is not None:
        seen(m)
        polled.append(m)
    for m in polled[::2]:  # commit half of them
        manual.commit_offset(m.topic(), m.partition(), m.offset() + 1)
    log.append(sorted(broker._groups[C.GROUP_ID].offsets.items()))
    manual.close()
    rejoined = K.KafkaClient(C.KafkaConfig(backend="memory", commit_after_process=True),
                             broker=broker)
    rejoined.setup_consumer([TOPIC])
    while (m := rejoined.poll_message()) is not None:  # the uncommitted tail
        seen(m)
    rejoined.close()
    auto = K.KafkaClient(C.KafkaConfig(backend="memory"), broker=broker)
    auto.setup_consumer(["ai_response"])
    broker.faults.drop_produce = lambda topic, value: value.get("drop", False)
    broker.faults.poison_produce = lambda topic, payload: payload.replace(b"x", b"y")
    producer.produce_message("ai_response", "k", {"drop": True})
    producer.produce_message("ai_response", "k", {"drop": False, "v": "xx"})
    producer.produce_error_message("ai_response", "k", {"error": True})
    while (m := auto.poll_message()) is not None:
        seen(m)
    auto.commit_offset("ai_response", 0, 99)  # a no-op in auto-commit mode
    log.append(sorted(broker._groups[C.GROUP_ID].offsets.items()))
    log.append((auto.num_partitions, auto.partition_for("conv-3"), sorted(auto.assignment())))
    log.append([m.value() for m in broker.drain(TOPIC)])
    return log


def test_poll_commit_and_faults_equal():
    got, want = _script(SIDES["port"]), _script(SIDES["jax"])
    assert got == want
    assert got[0] is None  # offset_reset=latest skipped the record produced before the join


def test_persisted_offsets_byte_equal_and_cross_read(tmp_path):
    _script(SIDES["port"], tmp_path / "port")
    _script(SIDES["jax"], tmp_path / "jax")
    name = tkafka.InMemoryBroker.OFFSETS_FILENAME
    assert name == jkafka.InMemoryBroker.OFFSETS_FILENAME
    got = (tmp_path / "port" / name).read_bytes()
    assert got == (tmp_path / "jax" / name).read_bytes()
    assert json.loads(got)
    # each package's fresh broker resumes from the other's file
    for reader, writer in (("port", "jax"), ("jax", "port")):
        K = SIDES[reader].kafka
        b = K.InMemoryBroker(num_partitions=4, offsets_dir=str(tmp_path / writer))
        for i in range(12):
            b.produce(TOPIC, f"conv-{i % 5}", b"%d" % i)
        b.join_group("message_consumer", "m", [TOPIC], "earliest")
        redelivered = []
        while (m := b.poll("message_consumer", "m", [TOPIC], auto_commit=False)) is not None:
            redelivered.append((m.partition(), m.offset()))
        saved = json.loads((tmp_path / writer / name).read_text())["message_consumer"]
        want = sorted((p, o) for p in range(4) for o in range(
            saved.get(f"{TOPIC}:{p}", 0), sum(1 for i in range(12)
                                               if b._partition_for(f"conv-{i % 5}") == p)))
        assert sorted(redelivered) == want


@pytest.mark.parametrize("side", ["port", "jax"])
def test_broker_offsets_persist_and_rewind(side, tmp_path):
    K = SIDES[side].kafka
    d = str(tmp_path)
    b1 = K.InMemoryBroker(offsets_dir=d)
    part = b1._partition_for("k")
    for i in range(3):
        b1.produce("t", "k", b"%d" % i)
    b1.join_group("g", "m1", ["t"], "earliest")
    for _ in range(3):
        assert b1.poll("g", "m1", ["t"], auto_commit=False) is not None
    b1.commit("g", "t", part, 2)
    b2 = K.InMemoryBroker(offsets_dir=d)
    for i in range(3):
        b2.produce("t", "k", b"%d" % i)
    b2.join_group("g", "m2", ["t"], "earliest")
    redelivered = []
    while (m := b2.poll("g", "m2", ["t"], auto_commit=False)) is not None:
        redelivered.append(m.offset())
    assert redelivered == [2]


@pytest.mark.parametrize("side", ["port", "jax"])
def test_broker_persisted_offset_beyond_log_clamps(side, tmp_path, caplog):
    K = SIDES[side].kafka
    d = str(tmp_path)
    b1 = K.InMemoryBroker(offsets_dir=d)
    part = b1._partition_for("k")
    for i in range(3):
        b1.produce("t", "k", b"%d" % i)
    b1.join_group("g", "m1", ["t"], "earliest")
    b1.commit("g", "t", part, 3)
    b3 = K.InMemoryBroker(offsets_dir=d)
    b3.produce("t", "k", b"0")
    with caplog.at_level("WARNING"):
        b3.join_group("g", "m3", ["t"], "earliest")
    assert any("beyond the log" in r.message for r in caplog.records)
    assert b3.poll("g", "m3", ["t"], auto_commit=False) is None


def test_confluent_backend_refused_without_the_library():
    import importlib.util

    if importlib.util.find_spec("confluent_kafka") is not None:
        pytest.skip("confluent_kafka is installed here")
    for side in SIDES.values():
        with pytest.raises(RuntimeError, match="confluent-kafka is not installed"):
            side.kafka.KafkaClient(side.cfg.KafkaConfig(backend="confluent"))
