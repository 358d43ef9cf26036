"""The port's serving app (``serve/app.py``, ``serve/http.py``) against the
JAX package's, over the cases of tests/test_app.py and the app cases of
tests/test_durability.py.

- Over ``StubGenerator`` both packages' ``build_app`` get the same
  generators, store contents and fake retriever, and must give equal
  ``ai_response`` streams byte for byte: the chunk schema (passthrough
  fields, ``stream_flush_tokens``), the error chunk, the watchdog's
  timeout chunk, dedupe, the commit watermark, journal-before-commit and
  its replay across packages, the failed id never journaled, the drain
  within its deadline, and the HTTP surface over a real socket
  (``/health``, ``/chat``, ``/chat/stream``, ``/metrics``,
  ``/debug/trace/``, ``/transactions``). Prometheus text from the same
  registry contents is byte-identical.
- Over each package's ``EngineGenerator`` on ``mini`` (fp32, the JAX
  weights converted by ``models/convert.py``), a Kafka turn's response is
  held by gate (b) and the two packages' chunks agree wherever the tokens
  do; the port's own ``build_app`` on ``mini`` (its ``_load_model_artifacts``
  and warmup, the prompt heads registered by the app) gives exactly the ids
  of a direct, cold ``LLMAgent`` turn over the same weights.
- One case per plane ``build_app`` refuses, the tokenizer-width rule, and
  the reference-side finding that rule answers: a 260-wide grammar mask
  cannot mask a wider logits row in the JAX package.
- Over a checkpoint and tokenizers written here (``tiny`` fp32 from a seeded
  transformers ``LlamaForCausalLM`` with a 260-id byte-level BPE, and
  ``bge-tiny`` from a seeded ``BertModel`` with a WordPiece vocabulary),
  both packages' ``build_app`` load them: a Kafka turn's response passes
  gate (b) and the chunks agree wherever the tokens do, the apps' encoders
  embed a query alike, an HF tokenizer of another width than the rows is
  refused (the JAX app fails at the decision's mask), and with
  ``model.quant="int8"`` the app's leaves equal the JAX app's streamed load.

No wall-clock assertion: a case waits on the broker's log or on a
counter, never on a duration.
"""

import asyncio
import dataclasses
import http.client
import itertools
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import finchat_tpu.serve.app as japp  # noqa: E402
import finchat_tpu_torch.serve.app as tapp  # noqa: E402
from finchat_tpu.agent.constrained import GrammarVocab as JaxGrammarVocab  # noqa: E402
from finchat_tpu.agent.constrained import TokenConstraint as JaxTokenConstraint  # noqa: E402
from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.generator import EngineGenerator as JaxEngineGenerator  # noqa: E402
from finchat_tpu.engine.generator import GenerationError as JaxGenerationError  # noqa: E402
from finchat_tpu.engine.generator import StubGenerator as JaxStub  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.io.kafka import InMemoryBroker as JaxBroker  # noqa: E402
from finchat_tpu.io.kafka import KafkaClient as JaxKafkaClient  # noqa: E402
from finchat_tpu.io.kafka import Message as JaxMessage  # noqa: E402
from finchat_tpu.io.store import InMemoryStore as JaxStore  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.config import load_config as jax_load_config  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu.utils.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from finchat_tpu.utils.tracing import TRACER as JAX_TRACER  # noqa: E402
from finchat_tpu_torch.agent import LLMAgent  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.generator import EngineGenerator, GenerationError, StubGenerator  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient, Message  # noqa: E402
from finchat_tpu_torch.io.store import InMemoryStore  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils.config import GROUP_ID, load_config  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS, MetricsRegistry  # noqa: E402
from finchat_tpu_torch.utils.tracing import TRACER  # noqa: E402

torch.set_float32_matmul_precision("highest")

USER_TOPIC, AI_TOPIC = "user_message", "ai_response"
CONTEXT_DOC = {"user_id": "u9", "name": "Alex", "income": 5000, "savings_goal": 800}
RETRIEVE = 'retrieve_transactions({"search_query": "coffee", "num_transactions": 2})'
MARGIN = 1e-3

SIDES = {
    "port": SimpleNamespace(app=tapp, build_app=tapp.build_app, Stub=StubGenerator,
                            Broker=InMemoryBroker, Client=KafkaClient, Message=Message,
                            Store=InMemoryStore, load_config=load_config, metrics=METRICS,
                            tracer=TRACER, GenErr=GenerationError),
    "jax": SimpleNamespace(app=japp, build_app=japp.build_app, Stub=JaxStub,
                           Broker=JaxBroker, Client=JaxKafkaClient, Message=JaxMessage,
                           Store=JaxStore, load_config=jax_load_config, metrics=JAX_METRICS,
                           tracer=JAX_TRACER, GenErr=JaxGenerationError),
}


async def retriever(args):
    return [f"txn for {args['user_id']}", "COFFEE $4.50 on 2026-07-30"]


@pytest.fixture(autouse=True)
def _clean_tracers():
    for side in SIDES.values():
        side.tracer.configure(enabled=True, flight_dir="")
        side.tracer.clear()
    yield


def _both(scenario):
    """Run ``scenario(side)`` on each package, each on a loop of its own."""
    return {name: asyncio.run(scenario(side)) for name, side in SIDES.items()}


def _same(got: dict):
    assert got["port"] == got["jax"], (got["port"], got["jax"])
    return got["port"]


def make_app(side, response_text="Hello there friend", tool_response="No tool call",
             fail=None, watchdog=None, chunk_delay=0.001, overrides=None, broker=None):
    cfg = side.load_config(overrides={"model.preset": "stub", **(overrides or {})})
    if watchdog is not None:
        cfg.engine.watchdog_seconds = watchdog
    broker = broker or side.Broker()
    store = side.Store()
    for conv in ("c1", "c2"):
        store.upsert_context(conv, CONTEXT_DOC)
        store.add_user_message(conv, "How am I doing?", "u9", timestamp=100)
    response = side.Stub(default=response_text, chunk_delay=chunk_delay)
    if fail is not None:
        response.fail_with = fail if isinstance(fail, str) else None
        if not isinstance(fail, str):  # a structured failure
            async def failing(prompt, sampling, **kw):
                raise side.GenErr("shed", code=fail[0], retryable=fail[1])
                yield  # pragma: no cover

            response.stream = failing
    app = side.build_app(cfg, store=store, kafka=side.Client(cfg.kafka, broker=broker),
                         tool_generator=side.Stub(default=tool_response),
                         response_generator=response, retriever=retriever)
    return app, broker, store


def inbound(message="How am I doing?", conversation_id="c1", **extra):
    return {"message": message, "conversation_id": conversation_id, "user_id": "u9", **extra}


def kafka_msg(side, payload, offset=-1, partition=0):
    return side.Message(USER_TOPIC, payload["conversation_id"], json.dumps(payload).encode(),
                        offset=offset, partition=partition)


def drained(broker) -> list[bytes]:
    return [m.value() for m in broker.drain(AI_TOPIC)]


def by_conversation(raw: list[bytes]) -> dict:
    out: dict = {}
    for v in raw:
        out.setdefault(json.loads(v)["conversation_id"], []).append(v)
    return out


async def wait_for(cond, ticks: int = 2000):
    for _ in range(ticks):
        if cond():
            return
        await asyncio.sleep(0.005)
    raise AssertionError("condition never held")


# --- the chunk protocol -----------------------------------------------------------

@pytest.mark.parametrize("flush", [1, 3])
@pytest.mark.parametrize("tool", ["No tool call", RETRIEVE])
def test_pipeline_chunk_schema_byte_for_byte(flush, tool):
    async def run(side):
        app, broker, store = make_app(side, response_text="You are doing fine this month.",
                                      tool_response=tool,
                                      overrides={"engine.stream_flush_tokens": flush})
        assert await app.process_message(kafka_msg(side, inbound(trace="t-1", n=3))) is True
        history = await store.get_history("c1")
        return drained(broker), [(m.sender, m.message) for m in history]

    out, history = _same(_both(run))
    chunks = [json.loads(v) for v in out]
    assert all(c["type"] == "response_chunk" and c["trace"] == "t-1" for c in chunks[:-1])
    assert len(chunks) - 1 == -(-6 // flush)  # six words, flush at a time
    assert chunks[-1]["type"] == "complete" and chunks[-1]["message"] == "How am I doing?"
    assert history[-1] == ("AIMessage", "".join(c["message"] for c in chunks[:-1]))


@pytest.mark.parametrize("fail", ["boom", ("deadline_exceeded", True), ("overloaded", False)],
                         ids=["plain", "retryable", "coded"])
def test_pipeline_error_chunk(fail):
    async def run(side):
        app, broker, _ = make_app(side, fail=fail)
        answered = await app.process_message(kafka_msg(side, inbound()))
        return answered, drained(broker)

    answered, out = _same(_both(run))
    assert answered is False and len(out) == 1
    err = json.loads(out[0])
    assert err["message"] == "" and err["error"] is True and "type" not in err
    if not isinstance(fail, str):
        assert err["code"] == fail[0]
        assert err.get("retryable") is (True if fail[1] else None)


def test_missing_context_drops_message():
    async def run(side):
        app, broker, _ = make_app(side)
        answered = await app.process_message(kafka_msg(side, inbound(conversation_id="nope")))
        return answered, drained(broker)

    assert _same(_both(run)) == (False, [])


def test_watchdog_timeout_chunk():
    async def run(side):
        app, broker, _ = make_app(side, watchdog=0.05, chunk_delay=10.0)
        a0 = side.tracer.snapshot()
        await app.start(serve_http=False)
        try:
            producer = side.Client(app.cfg.kafka, broker=broker)
            producer.produce_message(USER_TOPIC, "c1", inbound(message_id="m-w"))
            await wait_for(lambda: drained(broker))
            await wait_for(lambda: not app._inflight)
        finally:
            await app.stop()
        kinds = [ev[2] for ev in side.tracer.snapshot()[len(a0):] if ev[4] == "anomaly"]
        return drained(broker), kinds

    out, kinds = _same(_both(run))
    assert [json.loads(v)["message"] for v in out] == ["Request timed out. Please try again."]
    assert kinds == ["watchdog_timeout"]


def test_kafka_conversations_and_order():
    """Two conversations at once, two messages of one: each conversation's
    chunks equal across packages and in message order."""
    async def run(side):
        app, broker, _ = make_app(side, response_text="steady " * 6)
        await app.start(serve_http=False)
        try:
            producer = side.Client(app.cfg.kafka, broker=broker)
            producer.produce_message(USER_TOPIC, "c1", inbound(seq="first"))
            producer.produce_message(USER_TOPIC, "c2", inbound(conversation_id="c2"))
            producer.produce_message(USER_TOPIC, "c1", inbound(seq="second"))
            await wait_for(lambda: sum(json.loads(v).get("type") == "complete"
                                       for v in drained(broker)) == 3)
        finally:
            await app.stop()
        return by_conversation(drained(broker))

    got = _same(_both(run))
    c1 = [json.loads(v) for v in got["c1"]]
    completes = [i for i, e in enumerate(c1) if e.get("type") == "complete"]
    assert len(completes) == 2
    assert all(e["seq"] == "first" for e in c1[:completes[0] + 1])
    assert all(e["seq"] == "second" for e in c1[completes[0] + 1:])


# --- at-least-once: dedupe, the watermark, the journal ------------------------------

def _commit_on(app):
    app.cfg.kafka.commit_after_process = True
    app.kafka._manual_commit = True  # the client was built before the override
    app._commit_enabled = True


def test_commit_after_process_and_dedupe_ring():
    async def run(side):
        app, broker, _ = make_app(side, response_text="Once only.")
        _commit_on(app)
        await app.start(serve_http=False)
        try:
            d0 = side.metrics.get("finchat_kafka_dedupe_skips_total")
            c0 = side.metrics.get("finchat_kafka_commits_total")
            producer = side.Client(app.cfg.kafka, broker=broker)
            payload = inbound(message_id="m-1")
            producer.produce_message(USER_TOPIC, "c1", payload)
            producer.produce_message(USER_TOPIC, "c1", payload)  # a redelivery
            await wait_for(lambda: side.metrics.get("finchat_kafka_dedupe_skips_total") > d0
                           and not app._inflight
                           and side.metrics.get("finchat_kafka_commits_total") >= c0 + 1)
            offsets = sorted((t, p, o) for (t, p), o in broker._groups[GROUP_ID].offsets.items()
                             if t == USER_TOPIC and o)
            return (drained(broker), side.metrics.get("finchat_kafka_dedupe_skips_total") - d0,
                    offsets, "m-1" in app._seen_ids)
        finally:
            await app.stop()

    out, skips, offsets, kept = _same(_both(run))
    assert sum(json.loads(v).get("type") == "complete" for v in out) == 1
    assert skips == 1 and kept and sum(o for _t, _p, o in offsets) == 2


def test_commit_watermark_is_contiguous():
    """Completions out of offset order commit only the contiguous prefix."""
    async def run(side):
        app, _broker, _ = make_app(side)
        _commit_on(app)
        commits = []
        app.kafka.commit_offset = lambda t, p, n: commits.append((t, p, n))
        msgs = [kafka_msg(side, inbound(i=i), offset=10 + i // 2, partition=i % 2)
                for i in range(8)]
        for m in msgs:
            app._note_message_polled(m)
        for i in (2, 0, 4, 3, 1, 7, 6, 5):
            app._note_message_done(msgs[i])
        app._note_message_done(kafka_msg(side, inbound(), offset=-1))  # unpositioned: ignored
        return commits

    commits = _same(_both(run))
    assert [(p, n) for _t, p, n in commits] == [(0, 12), (0, 13), (1, 12), (0, 14), (1, 14)]


@pytest.fixture
def clock(monkeypatch):
    """A deterministic ``time.time_ns`` (the journal's seq seed), restarted
    per package by calling it."""
    state = {}

    def restart():
        state["c"] = itertools.count(1_700_000_000_000_000_000, 1_000)

    restart()
    monkeypatch.setattr(time, "time_ns", lambda: next(state["c"]))
    return restart


def _journal_app(side, path, fail=False, broker=None):
    app, broker, _store = make_app(side, response_text="You are doing fine.",
                                   fail="boom" if fail else None, broker=broker,
                                   overrides={"kafka.commit_after_process": True,
                                              "journal.path": str(path)})
    return app, broker


def test_answered_id_journaled_before_commit_and_replayed(tmp_path, clock):
    """The id is on disk when its offset commits, byte for byte the same
    journal in both packages; each package's restarted app replays the
    other's journal and skips the redelivery."""
    async def run(side):
        clock()
        path = tmp_path / side.app.__name__.split(".")[0]
        app, broker = _journal_app(side, path)
        seen_at_commit = []
        app.kafka.commit_offset = lambda t, p, n: seen_at_commit.append(
            (path / "answered-p0000.journal").read_bytes())
        msg = kafka_msg(side, inbound(message_id="mid-1"), offset=0)
        app._note_message_polled(msg)
        app._spawn_message_task(msg)
        await asyncio.gather(*app._inflight)
        await asyncio.sleep(0)  # the done callback
        app._journal.close()
        return seen_at_commit, (path / "answered-p0000.journal").read_bytes(), drained(broker)

    seen_at_commit, journal, out = _same(_both(run))
    assert seen_at_commit == [journal] and b"mid-1" in journal
    assert json.loads(out[-1])["type"] == "complete"

    async def restart(side, journal_dir):
        app, broker = _journal_app(side, journal_dir, broker=side.Broker())
        s0 = side.metrics.get("finchat_kafka_dedupe_skips_total")
        app._spawn_message_task(kafka_msg(side, inbound(message_id="mid-1"), offset=0))
        refused = not app._inflight
        app._journal.close()
        return ("mid-1" in app._seen_ids, refused,
                side.metrics.get("finchat_kafka_dedupe_skips_total") - s0, drained(broker))

    for reader in SIDES:
        for writer in ("finchat_tpu", "finchat_tpu_torch"):
            got = asyncio.run(restart(SIDES[reader], tmp_path / writer))
            assert got == (True, True, 1, []), (reader, writer, got)


def test_failed_id_never_journaled(tmp_path):
    async def run(side):
        path = tmp_path / side.app.__name__.split(".")[0]
        app, _broker = _journal_app(side, path, fail=True)
        msg = kafka_msg(side, inbound(message_id="mid-f"), offset=0)
        app._note_message_polled(msg)
        app._spawn_message_task(msg)
        await asyncio.gather(*app._inflight)
        await asyncio.sleep(0)
        app._journal.close()
        app2, _b = _journal_app(side, path)
        app2._journal.close()
        return "mid-f" in app._seen_ids, "mid-f" in app2._seen_ids, sorted(
            p.name for p in path.iterdir())

    assert _same(_both(run)) == (False, False, [])  # no journal file at all


def test_failed_message_id_is_retryable_not_deduped():
    async def run(side):
        app, broker, _ = make_app(side, fail="boom")
        _commit_on(app)
        await app.start(serve_http=False)
        try:
            producer = side.Client(app.cfg.kafka, broker=broker)
            payload = inbound(message_id="m-fail")
            producer.produce_message(USER_TOPIC, "c1", payload)
            await wait_for(lambda: drained(broker) and not app._inflight)
            stuck = "m-fail" in app._seen_ids
            d0 = side.metrics.get("finchat_kafka_dedupe_skips_total")
            producer.produce_message(USER_TOPIC, "c1", payload)  # the retry
            await wait_for(lambda: len(drained(broker)) == 2 and not app._inflight)
            return stuck, side.metrics.get("finchat_kafka_dedupe_skips_total") - d0, \
                drained(broker)
        finally:
            await app.stop()

    stuck, skips, out = _same(_both(run))
    assert not stuck and skips == 0 and all(json.loads(v)["error"] for v in out)


def test_app_drain_completes_inflight_within_deadline(tmp_path):
    async def run(side):
        path = tmp_path / side.app.__name__.split(".")[0]
        app, broker = _journal_app(side, path)
        app.cfg.shutdown.deadline_seconds = 30.0
        app.agent.response_generator.chunk_delay = 0.02
        await app.start(serve_http=False)
        producer = side.Client(app.cfg.kafka, broker=broker)
        producer.produce_message(USER_TOPIC, "c1", inbound(message_id="mid-d"))
        await wait_for(lambda: drained(broker))
        d0 = side.metrics.get("finchat_durability_graceful_drains_total")
        await app.drain_and_stop()
        drains = side.metrics.get("finchat_durability_graceful_drains_total") - d0
        gate = app._payload_error({"conversation_id": "c1", "message": "x", "user_id": "u9"})
        return drained(broker), drains, gate.status, json.loads(gate.body), not app._inflight

    out, drains, status, body, idle = _same(_both(run))
    assert json.loads(out[-1])["type"] == "complete" and drains == 1 and idle
    assert status == 503 and body["retryable"] is True


@pytest.mark.parametrize("depth,cap", [(1, None), (4, None), (1, 8), (4, 16)])
def test_repace_bursts_passes_every_update_in_order(depth, cap):
    """The SSE pacer: a passthrough at depth 1 (the only decode-loop depth
    the port's scheduler serves); with wider bursts it only delays, so both
    packages yield the same updates in the same order, errors included."""
    updates = [{"type": "status", "message": "s"}] + [
        {"type": "response_chunk", "content": f"t{i}"} for i in range(9)] + [
        {"type": "complete", "message": "done"}]

    async def run(side):
        async def source(fail: bool):
            for u in updates:
                yield dict(u)
            if fail:
                raise RuntimeError("mid-stream")

        got = [u async for u in side.app._repace_bursts(source(False), depth, burst_cap=cap)]
        err = []
        try:
            async for u in side.app._repace_bursts(source(True), depth, burst_cap=cap):
                err.append(u)
        except RuntimeError as e:
            err.append(str(e))
        return got, err

    got, err = _same(_both(run))
    assert got == updates and err == updates + ["mid-stream"]


# --- the HTTP surface ----------------------------------------------------------------

def _http(port: int, method: str, path: str, body: dict | None = None,
          headers: dict | None = None) -> tuple[int, str, str]:
    """One request over a real socket, stdlib only; (status, content type,
    body), chunked transfer decoded."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read().decode()
    finally:
        conn.close()


def _prometheus_ok(text: str) -> bool:
    """Every line of the exposition is a ``# TYPE`` / ``# exemplar`` comment
    or a ``name{labels} value`` sample with a float value, and it has at
    least one family."""
    import re

    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')
    lines = text.rstrip("\n").split("\n")
    for line in lines:
        if line.startswith("# TYPE ") or line.startswith("# exemplar "):
            continue
        if not sample.match(line):
            return False
        float(line.rsplit(" ", 1)[1])
    return any(line.startswith("# TYPE finchat_") for line in lines)


def _sse(text: str) -> list[dict]:
    return [json.loads(line[6:]) for line in text.split("\n") if line.startswith("data: ")]


def test_http_surface():
    async def run(side):
        app, _broker, _ = make_app(side, response_text="Advice here.", tool_response=RETRIEVE)
        app.server.port = 0  # ephemeral
        app.server.host = "127.0.0.1"
        await app.start(serve_http=True)
        port = app.server.port
        try:
            call = lambda *a, **k: asyncio.to_thread(_http, port, *a, **k)  # noqa: E731
            out = {}
            out["health"] = await call("GET", "/health")
            out["chat"] = await call("POST", "/chat", {"conversation_id": "c1",
                                                       "message": "hi", "user_id": "u9"})
            out["bad"] = await call("POST", "/chat", {"message": "hi"})
            out["missing"] = await call("GET", "/nope")
            out["method"] = await call("GET", "/chat")
            out["unknown_conv"] = await call("POST", "/chat", {"conversation_id": "zz",
                                                               "message": "hi", "user_id": "u"})
            status, ctype, text = await call(
                "POST", "/chat/stream", {"conversation_id": "c1", "message": "hi",
                                         "user_id": "u9"}, headers={"x-trace-id": "tr-1"})
            out["stream"] = (status, ctype, _sse(text))
            status, ctype, text = await call("GET", "/debug/trace/tr-1")
            names = [e["name"] for e in json.loads(text)["traceEvents"]]
            out["trace"] = (status, ctype, names[0], sorted(set(names)))
            out["trace_missing"] = (await call("GET", "/debug/trace/none"))[0]
            out["transactions"] = await call("POST", "/transactions",
                                             {"user_id": "u9", "transactions": [{"text": "x"}]})
            status, ctype, text = await call("GET", "/metrics")
            out["metrics"] = (status, ctype, _prometheus_ok(text))
            return out
        finally:
            await app.stop()

    out = _same(_both(run))
    assert out["health"] == (200, "application/json", '{"status": "healthy"}')
    assert out["chat"][0] == 200 and json.loads(out["chat"][2]) == {
        "response": "Advice here.", "retrieved_transactions_count": 2}
    assert out["bad"][0] == 400 and out["missing"][0] == 404 and out["method"][0] == 405
    assert out["unknown_conv"][0] == 404
    status, ctype, events = out["stream"]
    assert status == 200 and ctype == "text/event-stream"
    types = [e["type"] for e in events]
    assert types[0] == "status" and "retrieval_complete" in types and types[-1] == "complete"
    assert out["trace"][:3] == (200, "application/json", "ingress")
    assert out["trace_missing"] == 404
    assert out["transactions"][0] == 503 and "no retriever configured" in out["transactions"][2]
    assert out["metrics"] == (200, "text/plain; version=0.0.4", True)


def _feed(reg, view) -> None:
    reg.inc("finchat_b_total", 3)
    reg.inc("finchat_a_total")
    reg.inc("finchat_a_total", 2, labels={"replica": "1"})
    reg.set_gauge("finchat_g", 0.25)
    reg.set_gauge("finchat_g", 7, labels={"reason": "x"})
    for v in (0.001, 0.2, 3.0, 250.0):
        reg.observe("finchat_h_seconds", v)
    reg.observe("finchat_h_seconds", 0.04, labels={"replica": "0"},
                trace_id='evil"\nfinchat_forged 1\r\\')
    view.inc("finchat_kafka_commits_total")
    view.observe("finchat_ttft_seconds", 0.33, trace_id="t-9")
    view.set_gauge("finchat_breaker_state", 1)


def test_prometheus_text_byte_identical(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.5)
    texts = {}
    for name, cls in (("port", MetricsRegistry), ("jax", JaxRegistry)):
        reg = cls()
        _feed(reg, reg.labeled(replica="2"))
        texts[name] = reg.render_prometheus()
    assert texts["port"] == texts["jax"]
    lines = texts["port"].splitlines()
    assert "finchat_forged 1" not in lines
    assert 'finchat_a_total{replica="1"} 2.0' in lines
    assert any(line.startswith("# exemplar finchat_ttft_seconds{replica=\"2\"}") for line in lines)
    assert MetricsRegistry().labeled(replica=3).labels == {"replica": "3"}


# --- over the engine: mini, both packages ------------------------------------------

PAGE = 32
MAX_LEN = 1024
ENGINE = dict(max_seqs=4, page_size=PAGE, num_pages=4 * (MAX_LEN // PAGE) + 8,
              max_seq_len=MAX_LEN, prefill_chunk=32, partial_hold_ttl_seconds=600.0)
# prompts sized for a CPU run of mini: each head a whole page or more, so the
# app's registration shares it; the repo's prompts (~4k bytes) would not fit
# MAX_LEN
SYSTEM = ("You are Penny, a careful personal-finance assistant. Answer from the "
          "user's own accounts and transactions, briefly, and never invent numbers.")
TOOL = ("Decide whether transaction data is needed. Answer with one tool call "
        "or with the words No tool call.")
NEW = 16


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["mini"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


@pytest.fixture
def one_thread():
    """One intra-op thread for the engine's turns: under the suite's six
    workers on a few cores, torch's spinning intra-op threads slowed a mini
    turn past the app's 100 s watchdog (a turn takes ~4 s on one thread
    under that load, ~1 s alone on all cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def short_prompts(monkeypatch):
    for side in SIDES.values():
        monkeypatch.setattr(side.app, "load_prompts", lambda: (SYSTEM, TOOL))


def _recording(sched) -> list:
    handles = []
    submit = sched.submit

    async def recording_submit(*a, **k):
        h = await submit(*a, **k)
        handles.append(h)
        return h

    sched.submit = recording_submit
    return handles


def _jax_logits(models, ids: list[int]) -> np.ndarray:
    jcfg, jparams, _tc, _tp = models
    x = jnp.asarray([ids], jnp.int32)
    return np.asarray(jllama.forward_full(jparams, x, jnp.arange(len(ids))[None], config=jcfg,
                                          attn_backend="ref"))[0]


def _gate_b(models, handle) -> int:
    """Wherever the JAX forward's top-2 margin exceeds 1e-3, the served
    token is the JAX argmax; returns how many positions were decided."""
    prompt = list(handle.prompt_ids)
    served = list(handle.history[len(prompt):])
    assert served
    logits = _jax_logits(models, prompt + served[:-1])[len(prompt) - 1:]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > MARGIN
    want = logits.argmax(-1)
    bad = [i for i in range(len(served)) if decided[i] and want[i] != served[i]]
    assert not bad, (handle.seq_id, bad[:4])
    return int(decided.sum())


def _first_difference_near_tie(models, prompt, got, want) -> bool:
    n = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert len(got) == len(want)
        return True
    row = _jax_logits(models, prompt + want[:n])[-1]
    top2 = np.sort(row)[-2:]
    assert top2[1] - top2[0] <= MARGIN, (n, got[n], want[n], top2)
    return False


def _engine_cfg(side, **extra):
    return side.load_config(overrides={
        "model.preset": "stub", "engine.temperature": 0.0, "engine.max_new_tokens": NEW,
        **{f"engine.{k}": v for k, v in ENGINE.items()}, **extra})


def test_kafka_turn_over_engine_generators_matches_jax(models, short_prompts, one_thread):
    """Each package's ``EngineGenerator`` (mini, fp32, greedy) injected as
    the response role into its ``build_app``, a stub decision that
    retrieves: the Kafka turn's response passes gate (b), the hold is taken
    and grafted, and the packages' chunks are byte-equal wherever their
    tokens are."""
    jcfg, jparams, tcfg, tparams = models

    def make_engine(name):
        if name == "port":
            engine = InferenceEngine(tcfg, tparams, _engine_cfg(SIDES["port"]).engine,
                                     device="cpu")
            sched = ContinuousBatchingScheduler(engine, eos_id=ByteTokenizer().eos_id)
            return sched, EngineGenerator(sched, ByteTokenizer())
        engine = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), attn_backend="ref")
        sched = JaxScheduler(engine, eos_id=JaxTokenizer().eos_id)
        return sched, JaxEngineGenerator(sched, JaxTokenizer())

    async def run(name, sched, gen):
        side = SIDES[name]
        handles = _recording(sched)
        cfg = _engine_cfg(side)
        store = side.Store()
        store.upsert_context("c1", CONTEXT_DOC)
        store.add_user_message("c1", "How am I doing?", "u9", timestamp=100)
        broker = side.Broker()
        app = side.build_app(cfg, store=store, kafka=side.Client(cfg.kafka, broker=broker),
                             tool_generator=side.Stub(default=RETRIEVE),
                             response_generator=gen, retriever=retriever)
        await sched.start()
        try:
            answered = await app.process_message(
                kafka_msg(side, inbound("What did I spend on coffee?", message_id="mk-1")))
        finally:
            await sched.stop()
        assert sched.allocator.used_count == 0
        return answered, handles, drained(broker), await store.get_history("c1")

    # each engine built outside the loop, as a server builds its engine
    got = {name: asyncio.run(run(name, *make_engine(name))) for name in SIDES}
    answered, handles, out, history = got["port"]
    assert answered and got["jax"][0]
    response = handles[-1]
    assert response.grafted and response.conversation_id == "c1#resp"
    assert _gate_b(models, response) > 0
    chunks = [json.loads(v) for v in out]
    assert chunks[-1]["type"] == "complete"
    text = "".join(c["message"] for c in chunks if c.get("type") == "response_chunk")
    assert history[-1].message == text
    jresponse = got["jax"][1][-1]
    assert list(response.prompt_ids) == list(jresponse.prompt_ids)
    if _first_difference_near_tie(models, list(response.prompt_ids),
                                  response.history[len(response.prompt_ids):],
                                  jresponse.history[len(jresponse.prompt_ids):]):
        assert out == got["jax"][2]


def test_port_build_app_on_mini_equals_a_direct_agent_turn(models, short_prompts, one_thread):
    """The port's own ``build_app`` on ``mini`` (``_load_model_artifacts``
    from ``model.seed``, the engine warmed up, the prompt heads registered
    by the app), a Kafka turn through the consume loop: its response ids
    equal those of a direct, cold ``LLMAgent`` turn over the same weights
    exactly, and the turn hit the registered head."""
    cfg = _engine_cfg(SIDES["port"], **{"model.preset": "mini", "model.dtype": "float32",
                                        "model.seed": 3})

    store = InMemoryStore()
    store.upsert_context("c1", CONTEXT_DOC)
    store.add_user_message("c1", "How am I doing?", "u9", timestamp=100)
    broker = InMemoryBroker()
    app = tapp.build_app(cfg, store=store, kafka=KafkaClient(cfg.kafka, broker=broker),
                         tool_generator=StubGenerator(default=RETRIEVE),
                         retriever=retriever, device="cpu")
    assert app.scheduler is not None and len(app._registered_heads) == 2
    assert app.scheduler.engine.compiled_variants > 0  # warmed up at build
    handles = _recording(app.scheduler)

    async def through_app():
        h0 = METRICS.get("finchat_prefix_hits_total")
        await app.start(serve_http=False)
        try:
            producer = KafkaClient(cfg.kafka, broker=broker)
            producer.produce_message(USER_TOPIC, "c1", inbound("What about coffee?",
                                                               message_id="m-app"))
            await wait_for(lambda: any(json.loads(v).get("type") == "complete"
                                       for v in drained(broker)), ticks=20000)
            await wait_for(lambda: not app._inflight)
        finally:
            await app.stop()
        return METRICS.get("finchat_prefix_hits_total") - h0

    hits = asyncio.run(through_app())
    params, out = app.scheduler.engine.params, drained(broker)
    assert hits >= 1
    warm = handles[-1]
    assert warm.shared_len > 0

    # built outside the loop, as a server builds its engine before serving
    config = dataclasses.replace(tllama.PRESETS["mini"], dtype=torch.float32)
    sched = ContinuousBatchingScheduler(InferenceEngine(config, params, cfg.engine, device="cpu"),
                                        eos_id=ByteTokenizer().eos_id)
    rec = _recording(sched)
    agent = LLMAgent(StubGenerator(default=RETRIEVE), EngineGenerator(sched, ByteTokenizer()),
                     retriever, SYSTEM, TOOL,
                     response_sampling=SamplingParams(temperature=0.0, max_new_tokens=NEW))
    store = InMemoryStore()  # the turn's inputs, as the app's store held them
    store.upsert_context("c1", CONTEXT_DOC)
    store.add_user_message("c1", "How am I doing?", "u9", timestamp=100)

    async def direct():
        await sched.start()
        try:
            context, _uid = await store.get_context("c1")
            return [e async for e in agent.stream_with_status(
                "What about coffee?", "u9", context, await store.get_history("c1"),
                conversation_id="c1")]
        finally:
            await sched.stop()

    events = asyncio.run(direct())
    cold = rec[-1]
    assert cold.shared_len == 0 and list(cold.prompt_ids) == list(warm.prompt_ids)
    assert cold.history == warm.history
    kafka_text = "".join(json.loads(v)["message"] for v in out
                         if json.loads(v).get("type") == "response_chunk")
    assert kafka_text == "".join(e["content"] for e in events if e["type"] == "response_chunk")


# --- refusals, the tokenizer width, the reference-side finding ------------------------

REFUSALS = {
    # served since the engine fleet was ported: the case holds it served
    "fleet": ({"fleet.replicas": 2, "fleet.roles": "prefill,decode"}, None),
    # served since the warm-state fabric and the pod plane were ported: the
    # cases hold them built
    "fabric": ({"fabric.enabled": True}, None),
    "pod": ({"pod.host_id": "host-a"}, None),
    "mesh": ({"model.preset": "tiny", "mesh.data": 2, "mesh.model": 1}, "mesh"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_build_app_refuses_planes_not_ported(case, tmp_path):
    """The planes not ported are refused by name (the mesh). The others are
    built as the JAX package builds them: the stub preset builds no fleet and
    no fabric (both packages), and ``tiny`` builds an ``EngineFleet`` of two
    replicas with the parsed roles, or one engine over a ``WarmFabric`` at
    ``fabric.path``; ``pod.host_id`` builds a ``PodCoordinator`` of that
    host, with the app's Kafka client, journal and dedupe ring."""
    overrides, name = REFUSALS[case]
    if case == "fabric":
        overrides = {**overrides, "fabric.path": str(tmp_path / "fabric")}
    cfg = load_config(overrides={"model.preset": "stub", **overrides})

    def build(cfg):
        return tapp.build_app(cfg, store=InMemoryStore(),
                              kafka=KafkaClient(cfg.kafka, broker=InMemoryBroker()),
                              retriever=retriever, device="cpu")

    if name is not None:
        with pytest.raises(NotImplementedError, match=name.replace(".", r"\.")):
            build(cfg)
        return
    jcfg = jax_load_config(overrides={"model.preset": "stub", **overrides})
    jax_app = japp.build_app(jcfg, store=JaxStore(),
                             kafka=JaxKafkaClient(jcfg.kafka, broker=JaxBroker()),
                             retriever=retriever)
    app = build(cfg)
    assert app.fleet is None and jax_app.fleet is None
    assert app._max_inflight() == jax_app._max_inflight() == cfg.engine.max_seqs
    if case == "pod":
        assert type(app.pod).__name__ == type(jax_app.pod).__name__ == "PodCoordinator"
        assert app.pod.host_id == jax_app.pod.host_id == "host-a"
        assert app.pod.kafka is app.kafka and app.pod.dedupe is app._dedupe
        assert app.pod.peers == {} and app.pod.identity() == {
            "host_id": "host-a", "member_id": app.kafka.member_id}
        return
    assert app.pod is None and jax_app.pod is None
    cfg = load_config(overrides={
        "model.preset": "tiny", **overrides, "engine.max_seqs": 2, "engine.num_pages": 16,
        "engine.max_seq_len": 256, "engine.prefill_chunk": 32,
        "engine.warmup_on_start": False, "engine.prefix_cache": False})
    app = build(cfg)
    if case == "fabric":
        fabric = app.scheduler.fabric
        assert type(fabric).__name__ == "WarmFabric" and app.fleet is None
        assert app.scheduler.session_cache.disk is fabric.tier
        assert str(fabric.tier.path) == str(tmp_path / "fabric")
        fabric.close()
        return
    assert type(app.fleet).__name__ == "EngineFleet" and app.fleet.replicas[1].agent is not None
    assert [r.role for r in app.fleet.replicas] == ["prefill", "decode"]
    assert app.fleet.disagg is not None and app._dedupe is app.fleet.dedupe
    assert app._max_inflight() == 2 * cfg.engine.max_seqs


def test_app_keeps_fleet_and_pod_as_none():
    """With the planes off the app has no fleet and no pod; with
    ``pod.host_id`` it builds the pod plane, as the JAX app does, and attaches
    it to every scheduler it has (the stub preset has none)."""
    app, _b, _s = make_app(SIDES["port"])
    assert app.fleet is None and app.pod is None and app.scheduler is None
    assert app._max_inflight() == app.cfg.engine.max_seqs
    pods = {name: make_app(side, overrides={"pod.host_id": "host-b",
                                            "pod.listen": "inproc:app-host-b"})[0].pod
            for name, side in SIDES.items()}
    assert pods["port"].host_id == pods["jax"].host_id == "host-b"
    assert pods["port"].fleet is None and pods["jax"].fleet is None
    assert pods["port"].cfg.listen == pods["jax"].cfg.listen == "inproc:app-host-b"


def test_tokenizer_width_rule(monkeypatch):
    cfg = load_config(overrides={"model.preset": "tiny", "model.dtype": "float32"})
    _c, _p, tok, _d = tapp._load_model_artifacts(cfg, "cpu")
    assert (tok.vocab_size, tok.bos_id, tok.eos_id, tok.pad_id) == (260, 257, 258, 256)
    assert vars(tok) == vars(JaxTokenizer())
    wide = dataclasses.replace(tllama.PRESETS["tiny"], vocab_size=300)
    monkeypatch.setitem(tapp.PRESETS, "wide", wide)
    cfg = load_config(overrides={"model.preset": "wide", "model.dtype": "float32"})
    config, params, tok, _d = tapp._load_model_artifacts(cfg, "cpu")
    assert tok.vocab_size == config.vocab_size == params["embed"].shape[0] == 300
    assert (tok.bos_id, tok.eos_id) == (257, 258)
    assert tok.decode([72, 105, 299, 260, 258]) == "Hi"
    assert tok.encode("Hi", add_bos=True) == [257, 72, 105]


def test_reference_grammar_mask_cannot_mask_a_wider_logits_row():
    """The JAX package's own app would build its decision grammar 260 ids
    wide from ``get_tokenizer("")`` while a wider model's logits rows are
    wider: ``TokenConstraint.pick`` then fails to broadcast the mask
    (finchat_tpu/agent/constrained.py:415). The port's app gives a model
    wider than 260 ids a ``ByteTokenizer`` as wide as its rows instead."""
    vocab = JaxGrammarVocab.for_tokenizer(JaxTokenizer())
    assert len(vocab.token_strs) == 260
    logits = np.random.default_rng(0).standard_normal(300).astype(np.float32)
    with pytest.raises(ValueError, match="broadcast"):
        JaxTokenConstraint(vocab).pick(logits, 0.0, np.random.default_rng(0))
    ok = JaxTokenConstraint(vocab).pick(logits[:260], 0.0, np.random.default_rng(0))
    assert 0 <= ok < 260


# --- checkpoints and HF tokenizers through build_app -----------------------------

TINY_HF = dict(vocab_size=260, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=256, max_position_embeddings=2048,
               rope_theta=10_000.0, rms_norm_eps=1e-5)
BGE_TINY_HF = dict(vocab_size=260, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, max_position_embeddings=512, type_vocab_size=2,
                   hidden_act="gelu", layer_norm_eps=1e-12)
TOKEN_CORPUS = [SYSTEM, TOOL, "What did I spend on coffee?", "How am I doing?",
                "Hello there friend", "retrieve_transactions coffee"]


def _bpe_tokenizer(path, vocab_size: int) -> None:
    """A byte-level BPE of ``vocab_size`` ids: 256 bytes, 3 specials, the
    rest merges."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(TOKEN_CORPUS, trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<s>", "</s>", "<pad>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    assert tok.get_vocab_size() == vocab_size
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<s>", "eos_token": "</s>", "pad_token": "<pad>"}))


def _wordpiece_tokenizer(path) -> None:
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors

    vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789.,?!'$-":
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault("##" + ch, len(vocab))
    for word in ("coffee", "spend", "what", "did", "on", "how", "am", "doing"):
        vocab.setdefault(word, len(vocab))
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece()
    tok.post_processor = processors.BertProcessing(("[SEP]", 3), ("[CLS]", 2))
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "cls_token": "[CLS]",
        "sep_token": "[SEP]", "pad_token": "[PAD]", "unk_token": "[UNK]",
        "mask_token": "[MASK]"}))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """An HF ``tiny`` Llama checkpoint (fp32), its 260-id tokenizer, a
    ``bge-tiny`` BERT checkpoint and its WordPiece tokenizer, all seeded."""
    transformers = pytest.importorskip("transformers")
    from safetensors.torch import save_file as st_save

    root = tmp_path_factory.mktemp("app_ckpt")
    torch.manual_seed(17)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **TINY_HF, attn_implementation="eager")).eval()
    (root / "llama").mkdir()
    st_save({k: v.detach().float().contiguous() for k, v in llama.state_dict().items()},
            str(root / "llama" / "model.safetensors"))
    (root / "llama" / "config.json").write_text(json.dumps({**TINY_HF, "model_type": "llama"}))
    torch.manual_seed(18)
    bert = transformers.BertModel(transformers.BertConfig(
        **BGE_TINY_HF, attn_implementation="eager")).eval()
    (root / "bge").mkdir()
    st_save({k: v.detach().float().contiguous() for k, v in bert.state_dict().items()},
            str(root / "bge" / "model.safetensors"))
    (root / "bge" / "config.json").write_text(json.dumps({**BGE_TINY_HF, "model_type": "bert"}))
    _bpe_tokenizer(root / "tok", 260)
    _wordpiece_tokenizer(root / "bge-tok")
    return root


def _ckpt_overrides(root, **extra) -> dict:
    return {"model.preset": "tiny", "model.dtype": "float32",
            "model.checkpoint_path": str(root / "llama"), "model.tokenizer_path": str(root / "tok"),
            "embed.preset": "bge-tiny", "embed.checkpoint_path": str(root / "bge"),
            "embed.tokenizer_path": str(root / "bge-tok"), "engine.warmup_on_start": False,
            **extra}


def _jax_checkpoint_logits(root, ids: list[int]) -> np.ndarray:
    from finchat_tpu.checkpoints.hf_loader import load_llama_params as jax_load

    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jax_load(str(root / "llama"), jcfg)
    x = jnp.asarray([ids], jnp.int32)
    return np.asarray(jllama.forward_full(jparams, x, jnp.arange(len(ids))[None], config=jcfg,
                                          attn_backend="ref"))[0]


def test_kafka_turn_over_a_checkpoint_matches_jax(artifacts, short_prompts, one_thread):
    """Both packages' ``build_app`` over the same checkpoint, tokenizer, BERT
    checkpoint and BERT tokenizer (a stub decision that retrieves, the
    response on each app's own engine, each app's own retriever): the
    port's response passes gate (b) against the JAX forward on the JAX
    load, both apps render the same prompt ids through their HF
    tokenizers, the chunks are byte-equal wherever the tokens are, and the
    apps' encoders embed the query alike."""
    async def run(name):
        side = SIDES[name]
        cfg = _engine_cfg(side, **_ckpt_overrides(artifacts))
        store = side.Store()
        store.upsert_context("c1", CONTEXT_DOC)
        store.add_user_message("c1", "How am I doing?", "u9", timestamp=100)
        broker = side.Broker()
        kw = {"device": "cpu"} if name == "port" else {}
        app = side.build_app(cfg, store=store, kafka=side.Client(cfg.kafka, broker=broker),
                             tool_generator=side.Stub(default=RETRIEVE), **kw)
        sched = app.scheduler
        handles = _recording(sched)
        tok = app.agent.response_generator.tokenizer
        embedding = app.retriever.encoder.embed_query("What did I spend on coffee?")
        await sched.start()
        try:
            answered = await app.process_message(
                kafka_msg(side, inbound("What did I spend on coffee?", message_id="mk-c")))
        finally:
            await sched.stop()
        return answered, handles, drained(broker), tok, embedding

    got = {name: asyncio.run(run(name)) for name in SIDES}
    answered, handles, out, tok, embedding = got["port"]
    janswered, jhandles, jout, jtok, jembedding = got["jax"]
    assert answered and janswered
    assert type(tok).__name__ == "HFTokenizer" and tok.vocab_size == jtok.vocab_size == 260
    # bge-tiny runs in bf16 in both packages: held as test_torch_embed.py
    # holds the bf16 encoders, by cosine
    cosine = float(embedding @ jembedding / np.linalg.norm(embedding) / np.linalg.norm(jembedding))
    assert cosine >= 0.999, cosine
    response, jresponse = handles[-1], jhandles[-1]
    prompt = list(response.prompt_ids)
    assert prompt == list(jresponse.prompt_ids) and max(prompt) >= 256  # merged BPE ids
    served = list(response.history[len(prompt):])
    logits = _jax_checkpoint_logits(artifacts, prompt + served[:-1])[len(prompt) - 1:]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > MARGIN
    assert decided.sum() > 0
    assert all(logits[i].argmax() == served[i] for i in range(len(served)) if decided[i])
    jserved = list(jresponse.history[len(prompt):])
    n = next((k for k, (a, b) in enumerate(zip(served, jserved)) if a != b), None)
    chunks = [json.loads(v) for v in out]
    assert chunks[-1]["type"] == "complete"
    assert "".join(c["message"] for c in chunks if c.get("type") == "response_chunk") == \
        tok.decode([t for t in served if t != tok.eos_id])
    if n is None:
        assert served == jserved and out == jout
    else:  # the packages parted at a near tie of the JAX forward
        row = _jax_checkpoint_logits(artifacts, prompt + jserved[:n])[-1]
        top = np.sort(row)[-2:]
        assert top[1] - top[0] <= MARGIN, (n, served[n], jserved[n], top)


def test_int8_app_leaves_equal_the_jax_apps_streamed_load(artifacts):
    overrides = _ckpt_overrides(artifacts, **{"model.quant": "int8"})
    config, params, tok, _dev = tapp._load_model_artifacts(load_config(overrides=overrides),
                                                           "cpu")
    _jc, jparams, jtok, _mesh = japp._load_model_artifacts(jax_load_config(overrides=overrides))
    assert tok.vocab_size == jtok.vocab_size == config.vocab_size

    def flat(tree, prefix=""):
        for name, value in tree.items():
            if isinstance(value, dict):
                yield from flat(value, f"{prefix}{name}/")
            elif hasattr(value, "q"):
                yield f"{prefix}{name}.q", value.q
                yield f"{prefix}{name}.scale", value.scale
            else:
                yield prefix + name, value

    want = dict(flat(params_from_numpy(jax.device_get(jparams), "cpu")))
    mine = dict(flat(params))
    assert sorted(mine) == sorted(want) and "lm_head.q" in mine and "layers/mlp_up.q" in mine
    for name, leaf in mine.items():
        assert leaf.dtype == want[name].dtype and torch.equal(leaf, want[name]), name


def test_build_app_refuses_a_tokenizer_of_another_width(artifacts, tmp_path):
    """A 300-id tokenizer over ``tiny``'s 260 rows: the JAX app builds, then
    its decision's grammar mask (the tokenizer's width) cannot mask a
    logits row (the model's); the port refuses at ``build_app``, naming
    both widths."""
    _bpe_tokenizer(tmp_path / "wide-tok", 300)
    overrides = _ckpt_overrides(artifacts, **{"model.tokenizer_path": str(tmp_path / "wide-tok")})
    cfg = load_config(overrides=overrides)
    with pytest.raises(ValueError, match="the tokenizer has 300 ids, the model 260 logits rows"):
        tapp.build_app(cfg, store=InMemoryStore(), kafka=KafkaClient(cfg.kafka,
                                                                     broker=InMemoryBroker()),
                       retriever=retriever, device="cpu")
    from finchat_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer

    vocab = JaxGrammarVocab.for_tokenizer(JaxHFTokenizer(str(tmp_path / "wide-tok")))
    assert len(vocab.token_strs) == 300
    logits = np.random.default_rng(0).standard_normal(260).astype(np.float32)
    with pytest.raises(ValueError, match="broadcast"):
        JaxTokenConstraint(vocab).pick(logits, 0.0, np.random.default_rng(0))


def test_embed_checkpoint_without_tokenizer_warns_as_jax(artifacts, caplog):
    overrides = _ckpt_overrides(artifacts, **{"embed.tokenizer_path": ""})
    with caplog.at_level("WARNING"):
        r = tapp.build_retriever(load_config(overrides=overrides), None, "cpu")
    assert "embed.checkpoint_path is set but embed.tokenizer_path is not" in caplog.text
    assert isinstance(r.encoder.tokenizer, ByteTokenizer)
