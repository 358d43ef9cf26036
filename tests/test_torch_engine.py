"""The port's engine steps against the JAX package's, on CPU at fp32.

Both engines get the same converted ``tiny`` fp32 weights, the same page
tables and the same prompts; the JAX engine runs its reference attention
backend (the path the JAX package's CPU tests serve on).

Tolerances and why:
- logits and K/V pages, ``atol=2e-4``: the forward's fp32 matmuls already
  differ by ~1e-4 between the frameworks (see tests/test_torch_model.py).
- greedy tokens: equal wherever the JAX top-2 logit margin exceeds 1e-3
  (below it the 2e-4 logit noise may legitimately flip the argmax). The
  runs are teacher-forced: after every step both engines continue from the
  JAX token, so one near tie cannot derail the rest of the comparison.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.engine import commit_first_token as jax_commit  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler, check_supported  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402

torch.set_float32_matmul_precision("highest")

ATOL = 2e-4
MARGIN = 1e-3
ENGINE = dict(max_seqs=4, page_size=8, num_pages=40, max_seq_len=128, prefill_chunk=16,
              prefix_cache=False, session_cache=False, preemption=False, breaker_threshold=0)


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(11))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    tparams = params_from_numpy(jax.device_get(jparams), "cpu")

    def make():
        je = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), attn_backend="ref")
        te = InferenceEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
        return je, te

    return make


def _assert_greedy(tok_t: int, tok_j: int, logits_j: np.ndarray) -> None:
    top2 = np.sort(logits_j)[-2:]
    if top2[1] - top2[0] > MARGIN:
        assert tok_t == tok_j, (tok_t, tok_j, top2)


def _assert_pages(je, te, pages: list[int]) -> None:
    for name in ("k_pages", "v_pages"):
        want = np.asarray(getattr(je.state, name))[:, pages]
        got = getattr(te.state, name)[:, pages].numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=name)


def test_prefill_commit_and_decode_match_jax(engines):
    """prefill_step (3 chunks and 2 chunks, batched) -> commit_first_token ->
    8 decode steps, teacher-forced on the JAX tokens: logits, greedy
    tokens, context lengths and the written K/V pages agree."""
    je, te = engines()
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(0, 256, 37).tolist(), 2: rng.integers(0, 256, 20).tolist()}
    tables = {0: list(range(1, 8)), 2: list(range(8, 13))}
    je.set_page_table_rows(tables)
    te.set_page_table_rows(tables)
    items = list(prompts.items())
    lj = je.prefill_batch(items)
    lt = te.prefill_batch(items)
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    for (slot, _ids), logits_t, logits_j in zip(items, lt, lj):
        je.state, tok_j = jax_commit(je.state, jnp.int32(slot), logits_j, jnp.float32(0.0),
                                     jnp.float32(1.0), jnp.int32(0))
        tok_t = te.commit_first_token(slot, logits_t, 0.0, 1.0, 0)
        _assert_greedy(int(tok_t), int(tok_j), np.asarray(logits_j))
        te.set_last_token(slot, int(tok_j))  # teacher forcing
    B = ENGINE["max_seqs"]
    active = np.zeros(B, bool)
    active[list(prompts)] = True
    temp, top_p, top_k = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    for _step in range(8):
        toks_j, logits_j = je.decode(jnp.asarray(active), jnp.asarray(temp), jnp.asarray(top_p),
                                     jnp.asarray(top_k), return_logits=True)
        toks_t, logits_t = te.decode(active, temp, top_p, top_k, return_logits=True)
        toks_j, logits_j = np.asarray(toks_j), np.asarray(logits_j)
        for slot in prompts:
            np.testing.assert_allclose(logits_t[slot].numpy(), logits_j[slot], atol=ATOL, rtol=0)
            _assert_greedy(int(toks_t[slot]), int(toks_j[slot]), logits_j[slot])
            te.set_last_token(slot, int(toks_j[slot]))
    np.testing.assert_array_equal(te.state.context_lens.numpy(),
                                  np.asarray(je.state.context_lens))
    _assert_pages(je, te, tables[0] + tables[2])


def test_ragged_mixed_step_matches_jax(engines):
    """One packed ragged round: a 16-token prefill chunk that completes its
    prompt, a mid-prompt chunk, and two device-read decode rows beside
    padding — row logits, emitted tokens, context lengths and pages agree."""
    je, te = engines()
    rng = np.random.default_rng(1)
    tables = {0: [1, 2, 3, 4], 1: [5, 6, 7, 8], 2: [9, 10, 11, 12], 3: [13, 14, 15]}
    je.set_page_table_rows(tables)
    te.set_page_table_rows(tables)
    # slots 1 and 3 decode: prefill, then commit (teacher-forced)
    warm = [(1, rng.integers(0, 256, 19).tolist()), (3, rng.integers(0, 256, 9).tolist())]
    lj = je.prefill_batch(warm)
    lt = te.prefill_batch(warm)
    for (slot, _ids), logits_t, logits_j in zip(warm, lt, lj):
        je.state, tok_j = jax_commit(je.state, jnp.int32(slot), logits_j, jnp.float32(0.0),
                                     jnp.float32(1.0), jnp.int32(0))
        te.commit_first_token(slot, logits_t, 0.0, 1.0, 0)
        te.set_last_token(slot, int(tok_j))
    # slot 0 prefills its last 16-token chunk (starting at 16); slot 2 a
    # mid-prompt chunk at 0 of a longer prompt
    p0 = rng.integers(0, 256, 32).tolist()
    p2 = rng.integers(0, 256, 30).tolist()
    je.prefill_batch([(0, p0[:16])])
    te.prefill_batch([(0, p0[:16])])
    R = ENGINE["max_seqs"]
    packed = p0[16:32] + p2[0:16] + [0, 0]
    tok_row = [0] * 16 + [1] * 16 + [2, 3]
    T = te.ragged_bucket(len(packed))
    assert T == je.ragged_bucket(len(packed))
    packed += [0] * (T - len(packed))
    tok_row += [R] * (T - len(tok_row))
    row_slot = np.asarray([0, 2, 1, 3], np.int32)
    row_start = np.asarray([16, 0, 0, 0], np.int32)
    row_len = np.asarray([16, 16, 1, 1], np.int32)
    row_dev = np.asarray([False, False, True, True])
    row_arm = np.asarray([True, False, True, True])
    temp, top_p, top_k = np.zeros(R, np.float32), np.ones(R, np.float32), np.zeros(R, np.int32)
    args = [np.asarray(packed, np.int32), np.asarray(tok_row, np.int32), row_slot, row_start,
            row_len, row_dev, row_arm]
    em_j, n_j, logits_j, _blk = je.ragged_mixed(
        *[jnp.asarray(a) for a in args], jnp.zeros(R, jnp.int32), jnp.asarray(temp),
        jnp.asarray(top_p), jnp.asarray(top_k), jnp.zeros(R, bool), jnp.zeros(R, jnp.float32),
        jnp.ones(R, jnp.float32), jnp.zeros(R, jnp.int32), -1)
    em_t, n_t, logits_t = te.ragged_mixed(*args, temp, top_p, top_k)
    em_j, n_j, logits_j = np.asarray(em_j), np.asarray(n_j), np.asarray(logits_j)
    np.testing.assert_array_equal(n_t.numpy(), n_j)
    for r in range(4):
        np.testing.assert_allclose(logits_t[r].numpy(), logits_j[r], atol=ATOL, rtol=0)
        if row_arm[r]:
            _assert_greedy(int(em_t[r, 0]), int(em_j[r, 0]), logits_j[r])
    np.testing.assert_array_equal(te.state.context_lens.numpy(),
                                  np.asarray(je.state.context_lens))
    _assert_pages(je, te, sum(tables.values(), []))


def test_cuda_engine_refuses_to_fall_back(engines):
    """An engine asked for the card on a machine without one raises; it
    never moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _je, te = engines()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(te.config, te.params, te.engine_cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(te.config, te.params, te.engine_cfg)  # the default device


@pytest.mark.parametrize("field,value", [
    ("spec_tokens", 2), ("decode_loop_depth", 4), ("freerun_rounds", 2), ("kv_sink_pages", 2),
    ("kv_window_pages", 4),
])
def test_scheduler_refuses_planes_not_ported(engines, field, value):
    _je, te = engines()
    cfg = dataclasses.replace(EngineConfig(**ENGINE), **{field: value})
    with pytest.raises(NotImplementedError, match="not ported yet"):
        check_supported(cfg)
    te.engine_cfg = cfg
    with pytest.raises(NotImplementedError):
        ContinuousBatchingScheduler(te, eos_id=258)


def test_scheduler_serves_the_default_config(engines):
    """``EngineConfig()`` as it stands — preemption and the breaker on, the
    caches on — is a supported config, and a scheduler builds on it."""
    cfg = EngineConfig()
    assert cfg.preemption and cfg.breaker_threshold > 0
    check_supported(cfg)
    _je, te = engines()
    te.engine_cfg = dataclasses.replace(EngineConfig(**ENGINE), preemption=True,
                                        breaker_threshold=3)
    sched = ContinuousBatchingScheduler(te, eos_id=258)
    assert sched.preemption_enabled and sched.breaker_threshold == 3


@pytest.mark.parametrize("name", ["EngineConfig", "ModelConfig"])
def test_config_fields_match_jax(name):
    """Same field names and defaults as the JAX package's config sections."""
    from finchat_tpu.utils import config as jconfig
    from finchat_tpu_torch.utils import config as tconfig

    want = {f.name: f.default for f in dataclasses.fields(getattr(jconfig, name))}
    got = {f.name: f.default for f in dataclasses.fields(getattr(tconfig, name))}
    assert got == want
