"""The port's shared-prefix KV cache against the JAX package's, on CPU at fp32.

Both schedulers get the same converted ``tiny`` fp32 weights; the JAX
scheduler runs its reference attention backend. The engine-level cases of
the JAX package's tests/test_prefix_cache.py are held here on the port:

- golden equality: a prefix-cached request streams the same greedy tokens
  as an uncached one on the port (the head's KV is what the request would
  have written itself);
- accounting: a hit skips the shared tokens' prefill and allocates fewer
  pages, eviction never frees shared pages, retirement frees them only
  after the last reference;
- matching: whole pages only, at least one prompt token left to prefill,
  non-matching prompts unaffected;
- a registration on a running scheduler rides the rounds a chunk at a time
  and a concurrent stream keeps receiving tokens.

Across packages, on the same prompts: the same ``shared_len``, the same
page accounting, and greedy tokens under the teacher-forced contract
(streams equal up to their first difference, where the JAX forward's top-2
logit margin must be within 1e-3: an fp32 near tie the frameworks' ~1e-4
logit noise may flip).
"""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_leak_audit import port_scheduler_leak_audit  # noqa: E402,F401  (the leak audit)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

PAGE = 8
MARGIN = 1e-3
ENGINE = dict(max_seqs=4, page_size=PAGE, num_pages=128, max_seq_len=128, prefill_chunk=16,
              preemption=False, breaker_threshold=0)
HEAD = "system: you are a terse financial assistant, answer briefly."  # 58 chars


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _port(models, **over) -> ContinuousBatchingScheduler:
    _jcfg, _jp, tcfg, tparams = models
    cfg = EngineConfig(**{**ENGINE, **over})
    return ContinuousBatchingScheduler(InferenceEngine(tcfg, tparams, cfg, device="cpu"),
                                       eos_id=ByteTokenizer().eos_id)


def _jax(models, **over) -> JaxScheduler:
    jcfg, jparams, _tc, _tp = models
    eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **over}), attn_backend="ref")
    return JaxScheduler(eng, eos_id=ByteTokenizer().eos_id)


async def _collect(sched, seq_id, prompt_ids, n_new, jax_side=False):
    sampling = (JaxSampling if jax_side else SamplingParams)(temperature=0.0,
                                                             max_new_tokens=n_new)
    handle = await sched.submit(seq_id, prompt_ids, sampling)
    tokens = []
    while True:
        event = await asyncio.wait_for(handle.events.get(), timeout=120)
        if event["type"] == "token":
            tokens.append(event["token_id"])
        elif event["type"] == "done":
            return handle, tokens
        else:
            raise AssertionError(event)


def _serve_one(sched, prompt, n_new, head=None):
    """Register ``head`` (when given), then serve one greedy request."""
    shared = sched.register_prefix(head) if head is not None else 0

    async def run():
        await sched.start()
        try:
            return await _collect(sched, "s", prompt, n_new)
        finally:
            await sched.stop()

    handle, tokens = asyncio.run(run())
    return shared, handle, tokens


def _assert_teacher_forced(models, prompt, got, want):
    """The port's greedy stream equals the JAX one up to their first
    difference, and there the JAX forward's top-2 margin is a near tie."""
    jcfg, jparams, _tc, _tp = models
    assert got and want
    n = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert len(got) == len(want)
        return
    ids = jnp.asarray([prompt + want[:n]], jnp.int32)
    logits = np.asarray(jllama.forward_full(jparams, ids, jnp.arange(ids.shape[1])[None],
                                            config=jcfg, attn_backend="ref"))[0, -1]
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] <= MARGIN, (n, got[n], want[n], top2)


def test_check_supported_accepts_the_caches_at_their_defaults(models):
    """``EngineConfig(preemption=False, breaker_threshold=0)`` — prefix and
    session caches at their defaults — is served: a scheduler over an
    engine that keeps both caches at their defaults builds both."""
    cfg = EngineConfig(preemption=False, breaker_threshold=0)
    assert cfg.prefix_cache and cfg.session_cache
    sched = _port(models)
    assert sched.engine.engine_cfg.prefix_cache and sched.session_cache is not None


def test_register_shares_whole_pages_only(models):
    tok = ByteTokenizer()
    sched = _port(models)
    ids = tok.encode(HEAD, add_bos=True)
    shared = sched.register_prefix(ids)
    assert shared == (len(ids) // PAGE) * PAGE > 0
    # registration is idempotent and holds its pages under a prefix owner
    used_after = sched.allocator.used_count
    assert used_after == shared // PAGE
    assert sched.register_prefix(ids) == shared
    assert sched.allocator.used_count == used_after
    # a prefix shorter than a page registers nothing
    assert sched.register_prefix([1, 2, 3]) == 0
    # registration leaves the engine's slot state clean
    assert int(sched.engine.state.context_lens.sum()) == 0
    assert int(sched.engine.state.page_table.sum()) == 0
    assert sorted(sched.free_slots) == list(range(ENGINE["max_seqs"]))


def test_registered_head_pages_equal_jax(models):
    """The head's KV pages after registration agree with the JAX
    package's registration of the same head (fp32, atol 2e-4: the
    frameworks' matmuls differ by ~1e-4)."""
    tok = ByteTokenizer()
    ids = tok.encode(HEAD, add_bos=True)
    port, ref = _port(models), _jax(models)
    assert port.register_prefix(ids) == ref.register_prefix(ids) > 0
    assert port._prefixes[0].pages == ref._prefixes[0].pages
    pages = port._prefixes[0].pages
    for name in ("k_pages", "v_pages"):
        want = np.asarray(getattr(ref.engine.state, name))[:, pages]
        got = getattr(port.engine.state, name)[:, pages].numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0, err_msg=name)


def test_prefix_hit_streams_identical_tokens_and_saves_pages(models):
    tok = ByteTokenizer()
    prompt = tok.encode(HEAD + " q: how much did I spend?", add_bos=True)
    head = tok.encode(HEAD, add_bos=True)
    hits0 = METRICS.get("finchat_prefix_hits_total")
    saved0 = METRICS.get("finchat_prefix_tokens_saved_total")
    hit_sched = _port(models)
    shared, h_hit, hit_tokens = _serve_one(hit_sched, prompt, 10, head=head)
    _, h_miss, miss_tokens = _serve_one(_port(models), prompt, 10)
    assert shared > 0
    assert hit_tokens == miss_tokens  # golden equality on the port
    assert METRICS.get("finchat_prefix_hits_total") == hits0 + 1
    assert METRICS.get("finchat_prefix_tokens_saved_total") == saved0 + shared
    # the hit referenced the head pages and skipped their prefill
    assert h_hit.shared_len == shared and h_miss.shared_len == 0
    assert h_hit.page_list[: shared // PAGE] == hit_sched._prefixes[0].pages
    assert len(h_hit.page_list) == len(h_miss.page_list)
    # after the stream finished, only the prefix pages remain allocated
    hit_sched.allocator.check_invariants()
    assert hit_sched.allocator.used_count == shared // PAGE
    assert hit_sched._prefixes[0].refs == 0


def test_prefix_cache_matches_jax(models):
    """The same head and prompts through the JAX and port schedulers: the
    same shared length, page lists and accounting, and greedy tokens under
    the teacher-forced contract."""
    tok = ByteTokenizer()
    head = tok.encode(HEAD, add_bos=True)
    prompts = [tok.encode(HEAD + q, add_bos=True)
               for q in (" q: how much did I spend?", " q: rent?", " list my debts, please")]

    def run(sched, jax_side):
        shared = sched.register_prefix(head)

        async def go():
            await sched.start()
            try:
                return await asyncio.gather(*[
                    _collect(sched, f"s{i}", p, 12, jax_side=jax_side)
                    for i, p in enumerate(prompts)])
            finally:
                await sched.stop()

        return shared, asyncio.run(go()), sched

    shared_j, out_j, sj = run(_jax(models), True)
    shared_t, out_t, st = run(_port(models), False)
    assert shared_t == shared_j > 0
    for (hj, tj), (ht, tt), p in zip(out_j, out_t, prompts):
        assert ht.shared_len == hj.shared_len == shared_t
        assert ht.page_list == hj.page_list
        assert ht.prefill_pos == hj.prefill_pos == len(p)
        _assert_teacher_forced(models, p, tt, tj)
    assert st.allocator.used_count == sj.allocator.used_count == shared_t // PAGE
    assert st._prefixes[0].refs == sj._prefixes[0].refs == 0


def test_eviction_never_frees_shared_pages(models):
    tok = ByteTokenizer()
    sched = _port(models, max_seqs=2)
    ids = tok.encode(HEAD, add_bos=True)
    shared = sched.register_prefix(ids)
    prefix_pages = sched.allocator.used_count
    prompt = ids + tok.encode(" extra question", add_bos=False)

    async def run():
        await sched.start()
        try:
            for i in range(3):  # churn: admit, finish, slot reuse
                _, tokens = await _collect(sched, f"s{i}", prompt, 4)
                assert len(tokens) == 4
        finally:
            await sched.stop()

    asyncio.run(run())
    sched.allocator.check_invariants()
    assert sched.allocator.used_count == prefix_pages
    assert shared > 0


def test_non_matching_prompt_unaffected(models):
    tok = ByteTokenizer()
    sched = _port(models)
    sched.register_prefix(tok.encode(HEAD, add_bos=True))
    other = tok.encode("completely different beginning, same engine", add_bos=True)
    _, handle, tokens = _serve_one(sched, other, 5)
    assert len(tokens) == 5
    # no shared pages were attached: the whole prompt was prefilled
    assert handle.shared_len == 0 and handle.prefix_entry is None
    assert handle.prefill_pos == len(other)


def test_retire_frees_only_after_last_reference_releases(models):
    """Retired prefixes stop matching at once, but their pages survive
    until no in-flight page table references them."""
    tok = ByteTokenizer()
    sched = _port(models, max_seqs=2)
    ids = tok.encode(HEAD, add_bos=True)
    shared = sched.register_prefix(ids)
    assert shared > 0
    prompt = ids + tok.encode(" and a question", add_bos=False)

    async def run():
        await sched.start()
        try:
            handle = await sched.submit(
                "s", prompt, SamplingParams(temperature=0.0, max_new_tokens=24))
            event = await asyncio.wait_for(handle.events.get(), timeout=120)
            assert event["type"] == "token"  # admitted, decoding
            entry = handle.prefix_entry
            assert entry is not None and entry.refs == 1
            sched.retire_prefixes()
            # still referenced: the pages must NOT be freed yet
            assert sched.allocator.used_count >= shared // PAGE
            assert sched._match_prefix(prompt) == (None, 0)  # stops matching
            while (await asyncio.wait_for(handle.events.get(), timeout=120))["type"] != "done":
                pass
        finally:
            await sched.stop()

    asyncio.run(run())
    sched.allocator.check_invariants()
    assert sched._prefixes == []  # reaped after release
    assert sched.allocator.used_count == 0


def test_match_leaves_at_least_one_token_to_prefill(models):
    tok = ByteTokenizer()
    sched = _port(models)
    ids = tok.encode(HEAD, add_bos=True)
    shared = sched.register_prefix(ids)
    # a prompt that IS the registered head: the match stops below its end
    exact = ids[:shared]
    entry, used = sched._match_prefix(exact)
    assert used <= len(exact) - 1
    assert used % PAGE == 0 and entry is not None
    # a prompt one token longer uses the whole head
    assert sched._match_prefix(ids[: shared + 1]) == (entry, shared)


def test_chunked_registration_interleaves_with_decode(models):
    """``register_prefix_async`` on a running scheduler: the head prefills
    one chunk per round as a row of the ragged round beside the decoding
    stream, so the stream keeps receiving tokens DURING the registration,
    and the registered head then matches and serves like a sync
    registration's."""
    tok = ByteTokenizer()
    sched = _port(models)
    long_ids = tok.encode((HEAD + " ") * 2, add_bos=True)[: 96 + 1]  # 96 shared: 6 chunks
    mixed0 = METRICS.get("finchat_mixed_dispatches_total")

    async def run():
        await sched.start()
        try:
            stream = await sched.submit("stream", tok.encode("hello there", add_bos=True),
                                        SamplingParams(temperature=0.0, max_new_tokens=64))
            seen = 0
            while seen < 4:  # steady-state decode first
                event = await asyncio.wait_for(stream.events.get(), timeout=120)
                assert event["type"] == "token", event
                seen += 1
            reg = asyncio.create_task(sched.register_prefix_async(long_ids))
            during = 0
            while not reg.done():
                event = await asyncio.wait_for(stream.events.get(), timeout=120)
                if event["type"] != "token":
                    break
                during += 1
            shared = await reg
            while not stream.finished:
                await asyncio.wait_for(stream.events.get(), timeout=120)
            return shared, during
        finally:
            await sched.stop()

    shared, during = asyncio.run(run())
    assert shared == (len(long_ids) // PAGE) * PAGE
    assert during >= 3, f"stream starved during registration ({during} tokens)"
    assert METRICS.get("finchat_mixed_dispatches_total") >= mixed0 + 6
    assert not sched._prefix_jobs and len(sched._prefixes) == 1
    prompt = long_ids + tok.encode(" ok?", add_bos=False)
    _, h_chunked, chunked = _serve_one(sched, prompt, 8)
    assert h_chunked.shared_len == shared  # the hit engaged
    _, _, golden = _serve_one(_port(models), prompt, 8, head=long_ids)
    assert chunked == golden


def test_chunked_registration_on_an_idle_loop(models):
    """With nothing else to serve, a registration on a running scheduler
    rides the split prefill rounds alone and resolves to the same head
    (same pages, same KV) as a sync registration."""
    tok = ByteTokenizer()
    ids = tok.encode(HEAD, add_bos=True)
    sched = _port(models)

    async def run():
        await sched.start()
        try:
            return await asyncio.wait_for(sched.register_prefix_async(ids), timeout=120)
        finally:
            await sched.stop()

    shared = asyncio.run(run())
    sync = _port(models)
    assert shared == sync.register_prefix(ids) > 0
    pages = sched._prefixes[0].pages
    assert pages == sync._prefixes[0].pages
    assert sorted(sched.free_slots) == list(range(ENGINE["max_seqs"]))
    for name in ("k_pages", "v_pages"):
        assert torch.equal(getattr(sched.engine.state, name)[:, pages],
                           getattr(sync.engine.state, name)[:, pages]), name


def test_stop_fails_a_registration_in_flight(models):
    """A scheduler stopped mid-registration returns the job's pages and
    slot and resolves its future to 0."""
    tok = ByteTokenizer()
    sched = _port(models)

    async def run():
        await sched.start()
        reg = asyncio.create_task(sched.register_prefix_async(tok.encode(HEAD, add_bos=True)))
        await asyncio.sleep(0)  # the job is queued; the head needs 4 rounds
        assert len(sched._prefix_jobs) == 1 and sched.allocator.used_count > 0
        await sched.stop()  # at most one round ran
        return await reg

    assert asyncio.run(run()) == 0
    assert sched.allocator.used_count == 0 and not sched._prefix_jobs
    assert sorted(sched.free_slots) == list(range(ENGINE["max_seqs"]))

