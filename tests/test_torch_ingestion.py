"""The port's ``build_app`` with no injected retriever (serve/app.py's
``build_retriever``), as tests/test_ingestion.py drives the JAX package's:
it builds the encoder, the on-device index and the microbatcher from the
config, boots, ingests over HTTP and the ``transaction_upsert`` topic,
retrieves, and persists the index to ``vector.persist_path`` (debounced on
ingest, flushed once the consume loop idles, forced at shutdown), and a
second boot restores it. Beside the JAX package's app over the same
encoder weights (converted), an ingest-then-retrieve turn gives the same
``/chat`` answer and the same response prompt, retrieved rows and all."""

import asyncio
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import finchat_tpu.serve.app as japp  # noqa: E402
import finchat_tpu_torch.serve.app as tapp  # noqa: E402
from finchat_tpu.embed.index import DeviceVectorIndex as JaxIndex  # noqa: E402
from finchat_tpu.engine.generator import StubGenerator as JaxStub  # noqa: E402
from finchat_tpu.io.kafka import InMemoryBroker as JaxBroker  # noqa: E402
from finchat_tpu.io.kafka import KafkaClient as JaxKafkaClient  # noqa: E402
from finchat_tpu.io.kafka import Message as JaxMessage  # noqa: E402
from finchat_tpu.io.store import InMemoryStore as JaxStore  # noqa: E402
from finchat_tpu.utils.config import load_config as jax_load_config  # noqa: E402
from finchat_tpu_torch.embed.batcher import EmbedMicrobatcher  # noqa: E402
from finchat_tpu_torch.embed.encoder import bert_params_from_numpy  # noqa: E402
from finchat_tpu_torch.embed.index import DeviceVectorIndex  # noqa: E402
from finchat_tpu_torch.engine.generator import StubGenerator  # noqa: E402
from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient, Message  # noqa: E402
from finchat_tpu_torch.io.store import InMemoryStore  # noqa: E402
from finchat_tpu_torch.models.quant import QTensor  # noqa: E402
from finchat_tpu_torch.tools.retrieval import TransactionRetriever  # noqa: E402
from finchat_tpu_torch.utils.config import TRANSACTION_UPSERT_TOPIC, load_config  # noqa: E402

ROWS = [
    {"text": "Spent $4.50 at Blue Bottle Coffee", "date": 1000.0, "amount": -4.5},
    {"text": "Rent payment $1800", "date": 2000.0, "amount": -1800.0},
]
RETRIEVE = 'retrieve_transactions({"search_query": "coffee", "num_transactions": 5})'
CONTEXT_DOC = {"user_id": "u1", "name": "Alex", "income": 5000, "savings_goal": 800}

SIDES = {
    "port": SimpleNamespace(build_app=tapp.build_app, Stub=StubGenerator, Broker=InMemoryBroker,
                            Client=KafkaClient, Message=Message, Store=InMemoryStore,
                            load_config=load_config, kw={"device": "cpu"}),
    "jax": SimpleNamespace(build_app=japp.build_app, Stub=JaxStub, Broker=JaxBroker,
                           Client=JaxKafkaClient, Message=JaxMessage, Store=JaxStore,
                           load_config=jax_load_config, kw={}),
}


class Req:
    """A request object for the handlers (the HTTP server's fields they read)."""

    def __init__(self, body):
        self._body = body
        self.headers = {}

    def json(self):
        return self._body


def _make_app(tmp_path, side=SIDES["port"], tool="No tool call", overrides=None):
    cfg = side.load_config(overrides={"model.preset": "stub",
                                      "vector.persist_path": str(tmp_path / "vectors"),
                                      **(overrides or {})})
    broker, store = side.Broker(), side.Store()
    store.upsert_context("c1", CONTEXT_DOC)
    store.add_user_message("c1", "How am I doing?", "u1", timestamp=100)
    app = side.build_app(cfg, store=store, kafka=side.Client(cfg.kafka, broker=broker),
                         tool_generator=side.Stub(default=tool),
                         response_generator=side.Stub(default="ok"), **side.kw)
    return app, broker


@pytest.mark.parametrize("quant", ["", "int8"])
def test_build_app_builds_its_retriever_from_the_config(tmp_path, quant):
    app, _b = _make_app(tmp_path, overrides={
        "embed.quant": quant, "embed.batch_size": 8, "embed.batch_window_ms": 7.0,
        "embed.batch_max": 5, "vector.default_limit": 50})
    r = app.retriever
    assert isinstance(r, TransactionRetriever) and app.agent.retriever is r
    assert isinstance(r.index, DeviceVectorIndex) and r.index.device == torch.device("cpu")
    assert isinstance(r.batcher, EmbedMicrobatcher) and r.batcher.encoder is r.encoder
    assert (r.batcher.window_s, r.batcher.max_batch) == (0.007, 5)
    assert (r.encoder.batch_size, r.default_limit, r.encoder.quant) == (8, 50, quant)
    assert isinstance(r.encoder.params["layers"]["qkv"], QTensor) == bool(quant)
    assert r.encoder.dim == r.index.dim == 64  # embed.preset bge-tiny


def test_boot_ingest_retrieve_persist_roundtrip(tmp_path):
    """boot, ingest, retrieve, boot again: the rows survive the restart."""

    async def first_boot():
        app, _ = _make_app(tmp_path)
        assert await asyncio.to_thread(app._ingest_rows, "u1", ROWS) == 2
        rows = await app.retriever.structured({"user_id": "u1", "search_query": "coffee"})
        assert len(rows) == 2 and all(r["user_id"] == "u1" for r in rows)
        assert await app.retriever({"user_id": "other"}) == []

    asyncio.run(first_boot())
    assert (tmp_path / "vectors" / "transactions.npz").exists()

    async def second_boot():
        app, _ = _make_app(tmp_path)
        rows = await app.retriever.structured({"user_id": "u1", "search_query": "rent"})
        assert {r["page_content"] for r in rows} == {ROWS[0]["text"], ROWS[1]["text"]}
        assert {r.get("amount") for r in rows} == {-4.5, -1800.0}

    asyncio.run(second_boot())


def test_kafka_upsert_topic_ingests(tmp_path):
    async def run():
        app, _ = _make_app(tmp_path)
        msg = Message(TRANSACTION_UPSERT_TOPIC, "u2",
                      json.dumps({"user_id": "u2", "transactions": ROWS}).encode())
        await app.process_upsert(msg)
        return await app.retriever({"user_id": "u2"})

    assert len(asyncio.run(run())) == 2


def test_http_upsert_endpoint(tmp_path):
    async def run():
        app, _ = _make_app(tmp_path)
        resp = await app.upsert_transactions(Req({"user_id": "u3", "transactions": ROWS}))
        assert json.loads(resp.body.decode())["upserted"] == 2
        assert (await app.upsert_transactions(Req({"user_id": "u3"}))).status == 400
        bad = await app.upsert_transactions(Req({"user_id": "u3", "transactions": [{"date": 1}]}))
        assert bad.status == 400
        return await app.retriever({"user_id": "u3"})

    assert len(asyncio.run(run())) == 2


def test_debounced_snapshot_is_written_once_the_loop_idles(tmp_path):
    """A second ingest inside the debounce window only marks the snapshot
    due; the consume loop writes it once the window has passed, and the
    drain writes the last one."""
    snap = tmp_path / "vectors" / "transactions.jsonl"

    async def run():
        app, broker = _make_app(tmp_path)
        app._PERSIST_DEBOUNCE_S = 1.0
        await app.start(serve_http=False)
        try:
            await asyncio.to_thread(app._ingest_rows, "u4", ROWS[:1])
            written = len(snap.read_text().splitlines())
            await asyncio.to_thread(app._ingest_rows, "u4", ROWS[1:])
            due = app._persist_dirty, len(snap.read_text().splitlines())
            for _ in range(500):
                if not app._persist_dirty:
                    break
                await asyncio.sleep(0.02)
            idle = len(snap.read_text().splitlines())
            await asyncio.to_thread(app._ingest_rows, "u5", ROWS)
        finally:
            await app.drain_and_stop()
        return written, due, idle, len(snap.read_text().splitlines())

    assert asyncio.run(run()) == (1, (True, 1), 2, 4)


def test_the_idle_loop_sends_no_save_to_a_thread_inside_the_window(tmp_path):
    """While a debounced snapshot is due, the consume loop's idle passes
    check the window on the loop: ``_persist_index`` runs once, when the
    window has passed, not on every 10 ms pass inside it."""
    calls = []

    async def run():
        app, broker = _make_app(tmp_path)
        app._PERSIST_DEBOUNCE_S = 1.0
        await app.start(serve_http=False)
        try:
            await asyncio.to_thread(app._ingest_rows, "u4", ROWS[:1])
            await asyncio.to_thread(app._ingest_rows, "u4", ROWS[1:])
            persist = app._persist_index
            app._persist_index = lambda *a: (calls.append(a), persist(*a))
            await asyncio.sleep(0.3)
            inside = len(calls)
            for _ in range(500):
                if not app._persist_dirty:
                    break
                await asyncio.sleep(0.02)
            return inside, len(calls), app._persist_dirty
        finally:
            await app.drain_and_stop()

    assert asyncio.run(run()) == (0, 1, False)


QUERY = np.linspace(-1.0, 1.0, 64, dtype=np.float32)


def _hit_ids(index) -> list[str]:
    return [p.id for p in index.query_points(QUERY, limit=10, user_id="u1")]


async def _turn(side, tmp_path, encoder_params=None):
    """Boot with a stub tool role that retrieves, ingest over the topic,
    answer ``/chat``, drain. Returns the answer, the response prompt, the
    live index's hits and the snapshot's base."""
    app, broker = _make_app(tmp_path, side, tool=RETRIEVE)
    if encoder_params is not None:
        app.retriever.encoder.params = encoder_params
    await app.start(serve_http=False)
    try:
        producer = side.Client(app.cfg.kafka, broker=broker)
        producer.produce_message(TRANSACTION_UPSERT_TOPIC, "u1",
                                 {"user_id": "u1", "transactions": ROWS})
        producer.produce_message(TRANSACTION_UPSERT_TOPIC, "u9",
                                 {"user_id": "u9", "transactions": ROWS[:1]})
        for _ in range(500):
            if len(app.retriever.index) == 3:
                break
            await asyncio.sleep(0.01)
        resp = await app.chat(Req({"conversation_id": "c1", "message": "Coffee spend?",
                                   "user_id": "u1"}))
        prompt = app.agent.response_generator.calls[-1]
        live = _hit_ids(app.retriever.index)
    finally:
        await app.drain_and_stop()
    return json.loads(resp.body.decode()), prompt, live, app.cfg.vector.snapshot_base()


def test_ingest_then_retrieve_turn_equal_across_packages(tmp_path):
    jax_out = asyncio.run(_turn(SIDES["jax"], tmp_path / "jax"))
    jax_app, _b = _make_app(tmp_path / "weights", SIDES["jax"])
    params = bert_params_from_numpy(jax.device_get(jax_app.retriever.encoder.params), "cpu")
    port_out = asyncio.run(_turn(SIDES["port"], tmp_path / "port", params))
    assert port_out[0] == jax_out[0] == {"response": "ok", "retrieved_transactions_count": 2}
    assert port_out[1] == jax_out[1]
    assert ROWS[0]["text"] in port_out[1] and ROWS[1]["text"] in port_out[1]
    # the drained snapshot loads, in either package, with the live index's hits
    live, base = port_out[2], port_out[3]
    assert Path(base + ".npz").exists() and Path(base + ".jsonl").exists()
    restored = DeviceVectorIndex.load(base, dim=64, device="cpu")
    assert len(restored) == 3 and len(live) == 2
    assert _hit_ids(restored) == _hit_ids(JaxIndex.load(base, dim=64)) == live
