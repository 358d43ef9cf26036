"""The port's conversation store (``io/store.py``) against the JAX
package's: ``render_context`` strings, history order, the missing-context
and empty-history errors, ``save_ai_message`` documents, and ``make_store``
without ``pymongo`` (after tests/test_store.py)."""

import asyncio
import importlib.util

import numpy as np
import pytest

pytest.importorskip("torch")

import finchat_tpu.io.store as jstore  # noqa: E402
import finchat_tpu_torch.io.store as tstore  # noqa: E402
from finchat_tpu.utils.config import StoreConfig as JStoreConfig  # noqa: E402
from finchat_tpu_torch.utils.config import StoreConfig  # noqa: E402

CONTEXT_DOC = {
    "conversation_id": "conv-1",
    "user_id": "user-9",
    "name": "Alex",
    "income": 8000,
    "savings_goal": 1500,
    "accounts": [
        {"balances": {"available": 900.0, "current": 1234.5, "limit": None,
                      "iso_currency_code": "USD"},
         "official_name": "Plaid Gold Standard Checking"},
        {"balances": {}},
        {"balances": None, "official_name": "Card"},
    ],
    "additional_monthly_expenses": [
        {"name": "Gym", "amount": 40, "description": ""},
        {"name": "Rent", "amount": 2000, "description": "downtown apartment"},
    ],
}


def _docs(seed: int, n: int = 16) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc = {"name": f"N{i} ü", "income": int(rng.integers(0, 10_000)),
               "savings_goal": float(rng.random() * 100)}
        if rng.random() < 0.7:
            doc["accounts"] = [
                {"official_name": f"acct {k}",
                 "balances": {"current": float(rng.random()), "iso_currency_code": "EUR"}}
                if rng.random() < 0.6 else {"balances": {}}
                for k in range(int(rng.integers(0, 4)))]
        else:
            doc["accounts"] = None
        if rng.random() < 0.7:
            doc["additional_monthly_expenses"] = [
                {"name": f"e{k}", "amount": int(rng.integers(1, 99)),
                 "description": "" if rng.random() < 0.5 else f"d{k}"}
                for k in range(int(rng.integers(0, 4)))]
        out.append(doc)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_render_context_equal(seed):
    for doc in [CONTEXT_DOC] + _docs(seed):
        assert tstore.render_context(doc) == jstore.render_context(doc)


def _scenario(mod, cfg_cls):
    async def run():
        store = mod.InMemoryStore(cfg_cls())
        errors = []
        for coro in (store.get_context("nope"), store.get_history("conv-1")):
            try:
                await coro
            except LookupError as e:
                errors.append(str(e))
        store.upsert_context("conv-2", {**CONTEXT_DOC, "user_id": ""})
        try:
            await store.get_context("conv-2")
        except LookupError as e:
            errors.append(str(e))
        store.upsert_context("conv-1", CONTEXT_DOC)
        store.add_user_message("conv-1", "second", "user-9", timestamp=200)
        store.add_user_message("conv-1", "first", "user-9", timestamp=100)
        store.add_user_message("conv-1", "third", "user-9", timestamp=300)
        await store.save_ai_message("conv-1", "reply", "user-9")
        context = await store.get_context("conv-1")
        history = [(m.sender, m.message, m.user_id, m.conversation_id)
                   for m in await store.get_history("conv-1")]
        saved = {k: v for k, v in store._messages[-1].items() if k != "timestamp"}
        return errors, context, history, saved

    return asyncio.run(run())


def test_store_behaviour_equal():
    got, want = _scenario(tstore, StoreConfig), _scenario(jstore, JStoreConfig)
    assert got == want
    errors, context, history, _saved = got
    assert len(errors) == 3
    assert context[1] == "user-9"
    assert [h[1] for h in history[:3]] == ["first", "second", "third"]
    assert history[-1][0] == "AIMessage"


def test_make_store_without_pymongo():
    assert isinstance(tstore.make_store(StoreConfig()), tstore.InMemoryStore)
    assert isinstance(jstore.make_store(JStoreConfig()), jstore.InMemoryStore)
    if importlib.util.find_spec("pymongo") is not None:
        pytest.skip("pymongo is installed here")
    for mod, cfg in ((tstore, StoreConfig(backend="mongo")),
                     (jstore, JStoreConfig(backend="mongo"))):
        with pytest.raises(RuntimeError, match="pymongo is not installed"):
            mod.make_store(cfg)
