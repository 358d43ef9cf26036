"""The port's partial holds (the retrieval/prefill overlap) against the JAX
scheduler's, on CPU at fp32 with the converted ``tiny`` weights in both
packages, held against tests/test_retrieval_plane.py's partial and extend
cases and tests/test_mixed_step.py's parked-hold regression:

- hold, park and graft give the plain submit's greedy tokens: exactly
  within the port, and equal to the JAX package's teacher-forced (equal up
  to their first difference, where the JAX forward's top-2 margin is within
  1e-3);
- a divergent graft is refused and falls back, and the cancel frees every
  page; ``release_partial`` frees an abandoned hold; a stale hold is reaped
  at its TTL (waited for on its error event, not on a sleep);
- a hold over the registered head shares the head's pages and gives them
  back (the head's refcount) on the graft's end, a cancel and a reap;
- a parked hold survives a whole-round failure untouched, is preempted by a
  breaker trip and parks again, and ``shutdown_drain`` fails it without an
  offload.

The counters a scenario moves (``finchat_partial_*_total``) are equal
across packages.
"""

import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.generator import EngineGenerator as JaxGenerator  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.generator import EngineGenerator  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils import faults  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
PAGE = 8
ENGINE = dict(max_seqs=4, page_size=PAGE, num_pages=96, max_seq_len=192, prefill_chunk=16,
              session_cache=False)
COUNTERS = ("finchat_partial_holds_total", "finchat_partial_grafts_total",
            "finchat_partial_fallbacks_total", "finchat_partial_stale_reaps_total")

RNG = np.random.default_rng(0)
PREFIX = RNG.integers(1, 256, size=58).tolist()
FULL = PREFIX + RNG.integers(1, 256, size=30).tolist()


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.disarm_all()


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _sides(models):
    jcfg, jparams, tcfg, tparams = models

    def port(**over):
        engine = InferenceEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **over}), device="cpu")
        return ContinuousBatchingScheduler(engine, eos_id=-1)

    def jax_(**over):
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **over}), attn_backend="ref")
        return JaxScheduler(eng, eos_id=-1)

    return {
        "port": SimpleNamespace(make=port, metrics=METRICS, generator=EngineGenerator,
                                tokenizer=ByteTokenizer,
                                greedy=lambda n: SamplingParams(temperature=0.0,
                                                                max_new_tokens=n)),
        "jax": SimpleNamespace(make=jax_, metrics=JAX_METRICS, generator=JaxGenerator,
                               tokenizer=JaxTokenizer,
                               greedy=lambda n: JaxSampling(temperature=0.0, max_new_tokens=n)),
    }


def _both(models, scenario):
    return {name: asyncio.run(scenario(side)) for name, side in _sides(models).items()}


def _counters(metrics) -> dict:
    return {name: metrics.get(name) for name in COUNTERS}


def _delta(metrics, before: dict) -> dict:
    return {name: metrics.get(name) - v for name, v in before.items()}


async def _drain(handle):
    tokens = []
    while True:
        event = await asyncio.wait_for(handle.events.get(), timeout=120)
        if event["type"] == "token":
            tokens.append(event["token_id"])
        elif event["type"] == "done":
            return tokens, None
        else:
            return tokens, event


async def _parked(sched, handle):
    """Wait until the hold's prefix is prefilled and parked."""
    while not (handle.held and handle.slot >= 0
               and handle.prefill_pos >= len(handle.prompt_ids)):
        assert not handle.finished
        await asyncio.sleep(0.002)


def _assert_teacher_forced(models, prompt, got, want):
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


# --- golden equivalence -------------------------------------------------------

@pytest.mark.parametrize("mixed", [True, False], ids=["ragged", "split"])
def test_partial_graft_gives_the_plain_submit_tokens_as_jax(models, mixed):
    """A plain request decodes while the hold prefills, parks and is
    grafted (on the ragged round with ``mixed``, else the split rounds);
    the grafted stream equals a plain submit of the full prompt."""

    async def run(side):
        sched = side.make(mixed_step=mixed)
        before = _counters(side.metrics)
        await sched.start()
        try:
            plain, err = await _drain(await sched.submit("plain", FULL, side.greedy(10)))
            assert err is None
            other = await sched.submit("other", FULL[:40], side.greedy(24))
            other_task = asyncio.create_task(_drain(other))
            hold = await sched.submit_partial("hold", PREFIX, side.greedy(10))
            assert hold is not None and hold.held
            await _parked(sched, hold)
            assert hold.generated == 0 and hold not in sched.decoding.values()
            assert sched.extend_prompt(hold, FULL)
            assert hold.grafted and not hold.held
            grafted, err = await _drain(hold)
            assert err is None
            await other_task
            sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0
        finally:
            await sched.stop()
        return plain, grafted, _delta(side.metrics, before)

    got = _both(models, run)
    for name, (plain, grafted, delta) in got.items():
        assert grafted == plain, name
        assert delta == {"finchat_partial_holds_total": 1, "finchat_partial_grafts_total": 1,
                         "finchat_partial_fallbacks_total": 0,
                         "finchat_partial_stale_reaps_total": 0}, name
    _assert_teacher_forced(models, FULL, got["port"][1], got["jax"][1])


def test_graft_before_the_prefix_finishes_prefill(models):
    """A graft that lands while the hold is still prefilling (it has not
    parked yet) continues the same prefill: the stream equals the plain
    submit's."""
    side = _sides(models)["port"]

    async def go():
        sched = side.make()
        await sched.start()
        try:
            plain, _ = await _drain(await sched.submit("plain", FULL, side.greedy(8)))
            hold = await sched.submit_partial("hold", PREFIX, side.greedy(8))
            assert hold.prefill_pos == 0
            assert sched.extend_prompt(hold, FULL)
            grafted, err = await _drain(hold)
            assert err is None
        finally:
            await sched.stop()
        return plain, grafted

    plain, grafted = asyncio.run(go())
    assert grafted == plain


# --- fallbacks and leaks ------------------------------------------------------

def test_divergent_graft_falls_back_and_frees_every_page_as_jax(models):
    async def run(side):
        sched = side.make()
        before = _counters(side.metrics)
        await sched.start()
        try:
            hold = await sched.submit_partial("hold", PREFIX, side.greedy(4))
            await _parked(sched, hold)
            used = sched.allocator.used_count
            assert used > 0
            assert not sched.extend_prompt(hold, [9] + PREFIX)  # does not extend the prefix
            assert not sched.extend_prompt(hold, PREFIX)  # no new tokens
            assert hold.held and sched.allocator.used_count == used  # untouched
            sched.cancel(hold)
            assert hold.finished
            assert not sched.prefilling and not sched.decoding
            sched.allocator.check_invariants()
            left = sched.allocator.used_count
        finally:
            await sched.stop()
        return left, _delta(side.metrics, before)

    got = _both(models, run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0
    assert got["port"][1]["finchat_partial_fallbacks_total"] == 2


def test_release_partial_frees_an_abandoned_hold_as_jax(models):
    """A hold whose stream never runs (retrieval failed upstream) is
    released through the generator; a claimed one is left alone, and a
    grammar request takes no hold."""

    async def run(side):
        sched = side.make()
        await sched.start()
        try:
            gen = side.generator(sched, side.tokenizer())
            hold = await gen.begin_partial("<|system|>\nA long enough prefix text for a hold.\n",
                                           side.greedy(4))
            assert hold is not None
            await _parked(sched, hold)
            assert sched.allocator.used_count > 0
            gen.release_partial(hold)
            assert hold.finished and sched.allocator.used_count == 0
            sched.allocator.check_invariants()
            grammar = dataclasses.replace(side.greedy(4), grammar="tool_call")
            none = await gen.begin_partial("some prefix text", grammar)
            claimed = await gen.begin_partial("another prefix text, long enough", side.greedy(4))
            claimed._partial_claimed = True
            gen.release_partial(claimed)
            kept = not claimed.finished
            sched.cancel(claimed)
        finally:
            await sched.stop()
        return none, kept, len(hold.prompt_ids)

    got = _both(models, run)
    assert got["port"] == got["jax"] == (None, True, got["port"][2])


def test_generator_graft_and_fallback_through_stream(models):
    """``stream(..., partial=)``: a hold whose prefix the prompt extends is
    grafted (the text equals the plain generation's), one it does not is
    cancelled and the prompt submitted on its own, with the same text."""
    side = _sides(models)["port"]
    prefix_text = "<|system|>\nYou are Penny. Context: rent 1,850; groceries 142.\n"
    prompt = prefix_text + "<|user|>\nWhat should I do next?\n<|assistant|>\n"

    async def go():
        sched = side.make()
        gen = EngineGenerator(sched, ByteTokenizer())
        await sched.start()
        try:
            plain = await gen.generate(prompt, side.greedy(8))
            g0 = METRICS.get("finchat_partial_grafts_total")
            f0 = METRICS.get("finchat_partial_fallbacks_total")
            hold = await gen.begin_partial(prefix_text, side.greedy(8))
            grafted = await gen.generate(prompt, side.greedy(8), partial=hold)
            stale = await gen.begin_partial("<|system|>\nAnother head entirely.\n",
                                            side.greedy(8))
            fallback = await gen.generate(prompt, side.greedy(8), partial=stale)
            counts = (METRICS.get("finchat_partial_grafts_total") - g0,
                      METRICS.get("finchat_partial_fallbacks_total") - f0)
            assert stale.finished and sched.allocator.used_count == 0
        finally:
            await sched.stop()
        return plain, grafted, fallback, counts

    plain, grafted, fallback, counts = asyncio.run(go())
    assert grafted == plain and fallback == plain
    assert counts == (1, 1)


def test_stale_hold_is_reaped_at_its_ttl_as_jax(models):
    async def run(side):
        sched = side.make(partial_hold_ttl_seconds=0.05)
        before = _counters(side.metrics)
        await sched.start()
        try:
            hold = await sched.submit_partial("hold", PREFIX, side.greedy(4))
            tokens, err = await _drain(hold)  # the reap's error event, whenever it comes
            sched.allocator.check_invariants()
            left = sched.allocator.used_count
        finally:
            await sched.stop()
        return tokens, err, left, hold.finished, _delta(side.metrics, before)

    got = _both(models, run)
    assert got["port"] == got["jax"]
    tokens, err, left, finished, delta = got["port"]
    assert tokens == [] and err == {"type": "error", "message": "partial hold expired"}
    assert left == 0 and finished and delta["finchat_partial_stale_reaps_total"] == 1


# --- over the registered head -----------------------------------------------------

def test_hold_over_the_registered_head_shares_its_pages(models):
    """The hold's prefix starts with the registered head: admission points
    the hold at the head's pages, ``extend_prompt`` allocates only past its
    page list, and the head's refcount returns to 0 on the graft's end, on
    a cancel and on a reap, the head's pages still owned by the head."""
    head = FULL[:32]  # four whole pages
    side = _sides(models)["port"]

    async def go():
        sched = side.make(partial_hold_ttl_seconds=30.0)
        assert sched.register_prefix(head) == 32
        entry = sched._prefixes[0]
        head_pages = len(entry.pages)
        await sched.start()
        try:
            plain, _ = await _drain(await sched.submit("plain", FULL, side.greedy(8)))
            hold = await sched.submit_partial("hold", PREFIX, side.greedy(8))
            await _parked(sched, hold)
            assert hold.shared_len == 32 and entry.refs == 1
            own = len(sched.allocator.owned_by("hold"))
            assert own + 4 == len(hold.page_list)
            assert sched.extend_prompt(hold, FULL)
            want_own = -(-(len(FULL) + 8) // PAGE) - 4
            assert len(sched.allocator.owned_by("hold")) == want_own
            grafted, err = await _drain(hold)
            assert err is None and entry.refs == 0
            # a cancelled hold over the head
            cancelled = await sched.submit_partial("cancelled", PREFIX, side.greedy(8))
            await _parked(sched, cancelled)
            assert entry.refs == 1
            sched.cancel(cancelled)
            assert entry.refs == 0
            # a reaped one
            sched.hold_ttl_s = 0.05
            reaped = await sched.submit_partial("reaped", PREFIX, side.greedy(8))
            _, reap_err = await _drain(reaped)
            assert reap_err["message"] == "partial hold expired" and entry.refs == 0
            assert sched.allocator.used_count == head_pages
            sched.allocator.check_invariants()
        finally:
            await sched.stop()
        sched.retire_prefixes()
        assert sched.allocator.used_count == 0
        return plain, grafted

    plain, grafted = asyncio.run(go())
    assert grafted == plain


# --- the breaker's parked-hold branches -----------------------------------------------

def test_parked_hold_survives_a_whole_round_failure_untouched(models):
    """A whole prefill round fails while a hold is parked: the sequence in
    the round is preempted and replays, the parked hold is left as it was
    (not preempted, its prefix still prefilled), and its graft completes
    with the plain submit's tokens."""
    side = _sides(models)["port"]

    async def go():
        sched = side.make(mixed_step=False)
        eng = sched.engine
        real = eng.prefill_chunk
        state = {"armed": False, "fired": False}

        def flaky(*a, **k):
            if state["armed"]:
                state.update(armed=False, fired=True)
                raise RuntimeError("injected whole-round failure")
            return real(*a, **k)

        eng.prefill_chunk = flaky
        await sched.start()
        try:
            plain, _ = await _drain(await sched.submit("plain", FULL, side.greedy(5)))
            hold = await sched.submit_partial("hold", PREFIX, side.greedy(5))
            await _parked(sched, hold)
            state["armed"] = True
            victim = await sched.submit("victim", FULL[:20], side.greedy(5))
            victim_tokens, err = await _drain(victim)
            assert err is None and state["fired"] and victim.preempted == 1
            assert len(victim_tokens) == 5
            assert not hold.finished and hold.held and hold.preempted == 0
            assert hold in sched.prefilling and hold.prefill_pos >= len(hold.prompt_ids)
            assert sched.extend_prompt(hold, FULL)
            grafted, err = await _drain(hold)
            assert err is None
            sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0
        finally:
            await sched.stop()
        return plain, grafted

    plain, grafted = asyncio.run(go())
    assert grafted == plain


def test_breaker_trip_preempts_a_parked_hold_which_parks_again(models):
    """A breaker trip while a hold is parked preempts it with every live
    sequence; the replay re-prefills the prefix and parks again, and the
    graft then gives the plain submit's tokens."""
    side = _sides(models)["port"]

    async def go():
        sched = side.make()
        rebuilt = []
        sched.on_rebuild.append(lambda: rebuilt.append(True))
        await sched.start()
        try:
            plain, _ = await _drain(await sched.submit("plain", FULL, side.greedy(6)))
            hold = await sched.submit_partial("hold", PREFIX, side.greedy(6))
            await _parked(sched, hold)
            other = await sched.submit("other", FULL[:24], side.greedy(16))
            while other.generated < 2:
                await asyncio.sleep(0.002)
            faults.arm("scheduler.decode", faults.n_shot(
                sched.breaker_threshold, RuntimeError("wedged decode dispatch")))
            other_tokens, err = await _drain(other)
            assert err is None and len(other_tokens) == 16 and rebuilt
            assert hold.preempted == 1 and not hold.finished and hold.held
            await _parked(sched, hold)
            assert sched.extend_prompt(hold, FULL)
            grafted, err = await _drain(hold)
            assert err is None
            sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0
        finally:
            await sched.stop()
        return plain, grafted

    plain, grafted = asyncio.run(go())
    assert grafted == plain


def test_shutdown_drain_fails_a_held_handle_without_an_offload(models, tmp_path):
    """``shutdown_drain`` releases a parked hold and fails it with the
    retryable ``shutting_down`` error; a held prefix is no conversation
    state, so nothing is offloaded for it, while a decoding straggler of
    another conversation is."""
    side = _sides(models)["port"]

    async def go():
        sched = side.make(session_cache=True, session_cache_disk_path=str(tmp_path))
        await sched.start()
        hold = await sched.submit_partial("hold", PREFIX, side.greedy(8),
                                          conversation_id="conv-hold")
        await _parked(sched, hold)
        straggler = await sched.submit("straggler", FULL[:40], side.greedy(64),
                                       conversation_id="conv-live")
        while straggler.generated < 10:
            await asyncio.sleep(0.002)
        await sched.shutdown_drain()
        _, hold_err = await _drain(hold)
        _, live_err = await _drain(straggler)
        cache = sched.session_cache
        held_entry = cache.get("conv-hold")
        live_entry = cache.get("conv-live")
        used = sched.allocator.used_count
        cache.disk.close()
        return hold_err, live_err, held_entry, live_entry, used

    hold_err, live_err, held_entry, live_entry, used = asyncio.run(go())
    assert hold_err["code"] == live_err["code"] == "shutting_down"
    assert hold_err["retryable"]
    assert held_entry is None and live_entry is not None
    assert used == 0
