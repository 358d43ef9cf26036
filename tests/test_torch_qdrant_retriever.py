"""The port's external Qdrant backend (``tools/qdrant_retriever.py``) over
tests/test_qdrant_retriever.py's fake client, beside the JAX package's:
each case runs on both packages' retrievers and must give the same rows and
send the same requests (collection, query vector, limit, must-filter,
search parameters, upserted points and their stable ids), and the port's
``build_app`` picks the backend when ``vector.url`` is set."""

import asyncio

import pytest

torch = pytest.importorskip("torch")

import finchat_tpu.tools.qdrant_retriever as jqr  # noqa: E402
import finchat_tpu_torch.tools.qdrant_retriever as tqr  # noqa: E402
from test_qdrant_retriever import ALICE_HITS, NOW, FakeClient, FakeEncoder  # noqa: E402

SIDES = {"jax": jqr, "port": tqr}

CASES = {
    "no_user": {"search_query": "anything"},
    "empty_user": {"user_id": "", "search_query": "anything"},
    "alice": {"user_id": "alice", "search_query": "purchases"},
    "window": {"user_id": "alice", "search_query": "p", "time_period_days": 7},
    "limit": {"user_id": "alice", "search_query": "p", "num_transactions": 1},
    "default_limit": {"user_id": "alice", "num_transactions": None},
    "bob": {"user_id": "bob"},
}


def _run(mod, args, client=None):
    client = client or FakeClient(ALICE_HITS)
    r = mod.QdrantRetriever(FakeEncoder(), client=client, collection="transactions",
                            now=lambda: NOW)
    rows = asyncio.run(r.structured(args))
    return rows, client.query_calls


@pytest.mark.parametrize("case", list(CASES))
def test_rows_and_requests_equal_the_jax_package(case):
    rows, calls = _run(tqr, CASES[case])
    want_rows, want_calls = _run(jqr, CASES[case])
    assert rows == want_rows and calls == want_calls
    if case in ("no_user", "empty_user"):
        assert rows == [] and calls == []
    if case == "window":
        [call] = calls
        assert {"key": "metadata.date", "range": {"gte": int(NOW - 7 * 86_400)}} \
            in call["query_filter"]["must"]
        assert len(rows) == 2
    if case == "default_limit":
        assert calls[-1]["limit"] == 10_000


def test_posthoc_recheck_and_errors_on_both_sides():
    for mod in SIDES.values():
        client = FakeClient(ALICE_HITS)
        client.query_points = lambda **kw: type("R", (), {"points": ALICE_HITS})()
        rows, _ = _run(mod, CASES["alice"], client)
        assert len(rows) == 3 and all(r["user_id"] == "alice" for r in rows)
        broken = FakeClient(ALICE_HITS)
        broken.raise_on_query = ConnectionError("qdrant down")
        assert _run(mod, CASES["alice"], broken)[0] == []


def test_upsert_payloads_equal_the_jax_package():
    calls = {}
    for name, mod in SIDES.items():
        client = FakeClient()
        r = mod.QdrantRetriever(FakeEncoder(), client=client, now=lambda: NOW)
        r.upsert_transactions("alice", ["A $1", "B $2"], dates=[NOW, NOW],
                              metadatas=[{"amount": -1.0}, {"amount": -2.0}])
        r.upsert_transactions("alice", ["A $1"], dates=[NOW])
        calls[name] = client.upsert_calls
    assert calls["port"] == calls["jax"]
    first, again = calls["port"]
    assert first["points"][0]["payload"]["metadata"] == {"amount": -1.0, "user_id": "alice",
                                                         "date": NOW}
    assert again["points"][0]["id"] == first["points"][0]["id"]


def test_missing_client_package_raises_the_reference_message(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_qdrant(name, *a, **k):
        if name == "qdrant_client":
            raise ImportError("no qdrant_client")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_qdrant)
    with pytest.raises(RuntimeError, match="qdrant-client' package is not installed"):
        tqr.QdrantRetriever(FakeEncoder(), url="http://qdrant.example:6333")


def test_build_app_selects_qdrant_backend(monkeypatch):
    """``vector.url`` selects the backend (with the encoder built by the
    app on the CPU); ingestion reaches the external collection and the
    snapshot step does nothing (no local index)."""
    import finchat_tpu_torch.serve.app as tapp
    from finchat_tpu_torch.io.kafka import InMemoryBroker, KafkaClient
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.utils.config import load_config

    built = {}
    real_init = tqr.QdrantRetriever.__init__

    def fake_init(self, encoder, **kw):
        built.update(kw)
        real_init(self, encoder, client=FakeClient(), **kw)

    monkeypatch.setattr(tqr.QdrantRetriever, "__init__", fake_init)
    cfg = load_config(overrides={"model.preset": "stub", "vector.url": "http://qdrant.example:6333",
                                 "vector.api_key": "k", "vector.persist_path": "/nonexistent"})
    app = tapp.build_app(cfg, store=InMemoryStore(),
                         kafka=KafkaClient(cfg.kafka, broker=InMemoryBroker()), device="cpu")
    assert isinstance(app.retriever, tqr.QdrantRetriever)
    assert app.agent.retriever is app.retriever
    assert built["url"] == "http://qdrant.example:6333" and built["api_key"] == "k"
    assert built["collection"] == "transactions" and built["default_limit"] == 10_000
    assert app._ingest_rows("alice", [{"text": "X $9"}]) == 1
    [call] = app.retriever.client.upsert_calls
    assert len(call["points"][0]["vector"]) == 64  # the app's bge-tiny encoder
    app._persist_index(force=True)  # no local index: nothing written, nothing raised
