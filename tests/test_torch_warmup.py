"""The engine's warmup and device-state rebuild, on CPU at fp32.

- ``warmup`` runs the step variants the JAX engine's warmup runs for the
  same ``EngineConfig`` (``compiled_variants`` equal), and is state-neutral:
  every page but the trash page, the page table, the context lengths and
  ``kv_gaps`` are unchanged, and the last tokens but slot 0's, which its
  ``commit_first_token`` sets to 0 (a slot's first prefill completion
  overwrites it), over the bf16-shaped float cache and the int8 cache with
  its scale planes;
- greedy tokens served after a warmup equal those served without one
  (warmup advances the sampling generator, which greedy streams never
  read), and the scheduler reports the variant count;
- ``rebuild_device_state`` replaces the whole state with a fresh one of the
  same shapes and dtypes, the weights kept.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

ENGINE = dict(max_seqs=4, page_size=8, num_pages=32, max_seq_len=128, prefill_chunk=16,
              session_cache=False)
STATE = ("k_pages", "v_pages", "k_scales", "v_scales", "page_table", "context_lens",
         "last_tokens", "kv_gaps")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(3))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _port(models, **over) -> InferenceEngine:
    _jcfg, _jp, tcfg, tparams = models
    return InferenceEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **over}), device="cpu")


def _snapshot(engine) -> dict:
    s = engine.state
    return {name: None if getattr(s, name) is None else getattr(s, name).clone()
            for name in STATE}


@pytest.mark.parametrize("mixed_step", [True, False])
def test_compiled_variants_equal_jax(models, mixed_step):
    jcfg, jparams, _tc, _tp = models
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, mixed_step=mixed_step),
                   attn_backend="ref")
    je.warmup()
    te = _port(models, mixed_step=mixed_step)
    assert te.compiled_variants == 0
    seconds = te.warmup()
    assert seconds > 0
    # prefill batches 1, 2, 4; the one packed-token bucket (64); decode with
    # and without logits; commit_first_token
    assert te.compiled_variants == je.compiled_variants == (7 if mixed_step else 6)


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_warmup_is_state_neutral(models, kv_quant):
    """Slots 1 and 3 hold live sequences (pages written, a first token
    committed, context lengths set) when warmup runs: it leaves everything
    they read as it was."""
    te = _port(models, kv_quant=kv_quant)
    rng = np.random.default_rng(0)
    tables = {1: [3, 4, 5], 3: [9, 10]}
    te.set_page_table_rows(tables)
    items = [(1, rng.integers(1, 256, 21).tolist()), (3, rng.integers(1, 256, 11).tolist())]
    for (slot, _ids), logits in zip(items, te.prefill_batch(items)):
        te.commit_first_token(slot, logits, 0.0, 1.0, 0)
    te.set_last_token(0, 77)  # slot 0's token is the one warmup may overwrite
    before = _snapshot(te)
    te.warmup()
    after = _snapshot(te)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        if before[name] is None:
            assert after[name] is None
            continue
        assert torch.equal(after[name][:, 1:], before[name][:, 1:]), name  # page 0 is trash
    for name in ("page_table", "context_lens", "kv_gaps"):
        assert torch.equal(after[name], before[name]), name
    assert torch.equal(after["last_tokens"][1:], before["last_tokens"][1:])
    assert int(after["last_tokens"][0]) == 0
    assert te.state.context_lens.tolist() == [0, 21, 0, 11]


def test_greedy_tokens_after_warmup_equal_those_without(models):
    prompts = [list(range(1, 30)), list(range(40, 52))]

    async def serve(warm: bool):
        engine = _port(models)
        if warm:
            engine.warmup()
        sched = ContinuousBatchingScheduler(engine, eos_id=-1)
        await sched.start()
        try:
            variants = METRICS.get("finchat_warmup_compiled_variants")
            handles = [await sched.submit(f"s{i}", p, SamplingParams(temperature=0.0,
                                                                    max_new_tokens=10))
                       for i, p in enumerate(prompts)]
            out = []
            for h in handles:
                tokens = []
                while (ev := await asyncio.wait_for(h.events.get(), 60))["type"] == "token":
                    tokens.append(ev["token_id"])
                assert ev == {"type": "done", "reason": "length"}
                out.append(tokens)
        finally:
            await sched.stop()
        return out, variants

    cold, cold_variants = asyncio.run(serve(False))
    warm, warm_variants = asyncio.run(serve(True))
    assert warm == cold
    assert (cold_variants, warm_variants) == (0, 7)


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_rebuild_device_state_replaces_the_state_and_keeps_the_weights(models, kv_quant):
    te = _port(models, kv_quant=kv_quant)
    params = te.params
    te.set_page_table_rows({2: [5, 6]})
    te.prefill_batch([(2, list(range(1, 12)))])
    old = te.state
    shapes = {n: (getattr(old, n).shape, getattr(old, n).dtype) for n in STATE
              if getattr(old, n) is not None}
    te.rebuild_device_state()
    new = te.state
    assert new is not old and te.params is params
    for name in STATE:
        t = getattr(new, name)
        if t is None:
            assert getattr(old, name) is None
            continue
        assert (t.shape, t.dtype) == shapes[name] and not t.any(), name
        assert t.data_ptr() != getattr(old, name).data_ptr()
    # the generator starts over from the engine's seed
    fresh = torch.Generator().manual_seed(ENGINE["max_seqs"])
    assert torch.equal(new.generator.get_state(), fresh.get_state())
