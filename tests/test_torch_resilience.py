"""The port's resilience plane against the JAX scheduler's, on CPU at fp32.

Both schedulers get the same converted ``tiny`` fp32 weights (the JAX one
serves on its reference attention backend) and run the same scenario, the
cases of the JAX package's tests/test_resilience.py, tests/test_fleet.py's
adopt and tests/test_durability.py's shutdown drain:

- recompute preemption: a direct preempt and replay, and page pressure
  (the latest-deadline victim yields);
- the circuit breaker: a trip through ``scheduler.decode`` and through
  ``scheduler.mixed``, the give-up after ``breaker_max_rebuilds`` and the
  recovery after it, a failed rebuild, ``revive``;
- deadline admission: a shed, EDF order with the starvation guard,
  ``OverloadedError``;
- ``adopt`` and ``shutdown_drain``.

Held across packages: the counter deltas and error events (dicts equal
byte for byte), and the greedy token streams under the teacher-forced
contract of the port's other scheduler tests (equal up to their first
difference, where the JAX forward's top-2 logit margin must be within 1e-3:
an fp32 near tie the frameworks' ~1e-4 logit noise may flip). On the port
alone, a replayed stream equals its uninterrupted run exactly. No assertion
reads the wall clock: faults are armed on stream progress or on a dispatch
count, and EDF order is set through the handles' ``submitted_at`` and
``deadline``.

Port only: the epoch (a replay re-admitted into the same slot never
receives the token of the step that was in flight when it was preempted),
and the fault seams of the session and disk tiers.
"""

import asyncio
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.generator import EngineGenerator as JaxGenerator  # noqa: E402
from finchat_tpu.engine.generator import GenerationError as JaxGenerationError  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.engine.scheduler import OverloadedError as JaxOverloaded  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer  # noqa: E402
from finchat_tpu.utils import faults as jfaults  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.generator import EngineGenerator, GenerationError  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import (  # noqa: E402
    ContinuousBatchingScheduler,
    OverloadedError,
)
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.serve.simple import LLMService  # noqa: E402
from finchat_tpu_torch.utils import faults  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

MARGIN = 1e-3
PAGE = 8
# tests/test_resilience.py's scheduler: two slots, pages of 8, chunks of 16,
# the session cache off; preemption and the breaker at their defaults
ENGINE = dict(max_seqs=2, page_size=PAGE, num_pages=64, max_seq_len=128, prefill_chunk=16,
              session_cache=False)
COUNTERS = ("finchat_preemptions_total", "finchat_dispatch_failures_total",
            "finchat_engine_rebuilds_total", "finchat_sheds_total",
            "finchat_overload_rejections_total")


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.disarm_all()
    jfaults.disarm_all()


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _sides(models):
    """Each package's stack, addressed the same way by the scenarios."""
    jcfg, jparams, tcfg, tparams = models

    def port(eos_id=-1, **over):
        cfg = EngineConfig(**{**ENGINE, **over})
        return ContinuousBatchingScheduler(InferenceEngine(tcfg, tparams, cfg, device="cpu"),
                                           eos_id=eos_id)

    def jax_(eos_id=-1, **over):
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **over}), attn_backend="ref")
        return JaxScheduler(eng, eos_id=eos_id)

    return {
        "port": SimpleNamespace(make=port, faults=faults, metrics=METRICS,
                                greedy=lambda n: SamplingParams(temperature=0.0,
                                                                max_new_tokens=n),
                                overloaded=OverloadedError),
        "jax": SimpleNamespace(make=jax_, faults=jfaults, metrics=JAX_METRICS,
                               greedy=lambda n: JaxSampling(temperature=0.0, max_new_tokens=n),
                               overloaded=JaxOverloaded),
    }


def _both(models, scenario):
    """Run ``scenario(side)`` on each package; returns {package: result}."""
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


# --- recompute preemption ---------------------------------------------------

def test_direct_preempt_replay_matches_jax(models):
    """``_preempt`` mid-decode, then the replay: the stream completes with
    the exact tokens of an uninterrupted run, in both packages."""
    prompt = list(range(1, 20))

    def scenario(preempt_at):
        async def run(side):
            sched = side.make()
            before = _counters(side.metrics)
            await sched.start()
            try:
                handle = await sched.submit("s", prompt, side.greedy(12))
                task = asyncio.create_task(_drain(handle))
                if preempt_at is not None:
                    while handle.generated < preempt_at:
                        await asyncio.sleep(0.002)
                    sched._preempt(handle)
                tokens, err = await task
                sched.allocator.check_invariants()
            finally:
                await sched.stop()
            return tokens, err, handle.preempted, _delta(side.metrics, before)
        return run

    clean = _both(models, scenario(None))
    replay = _both(models, scenario(4))
    for name in ("port", "jax"):
        tokens, err, n_pre, delta = replay[name]
        assert err is None and n_pre == 1
        assert delta["finchat_preemptions_total"] == 1
        assert tokens == clean[name][0], f"{name}: the replay duplicated or dropped tokens"
    assert replay["port"][3] == replay["jax"][3]
    _assert_teacher_forced(models, prompt, replay["port"][0], replay["jax"][0])


def test_page_pressure_preempts_latest_deadline_victim_as_jax(models):
    """With 7 usable pages, a deadline-less hog holding 6 yields to an
    urgent request with a deadline; both complete, and the hog's replayed
    stream equals its uncontended one."""
    hog_prompt = list(range(1, 24))  # + 24 new: 6 of the 7 usable pages
    urgent_prompt = list(range(40, 56))  # + 8 new: 3 pages, so the hog must yield

    def scenario(contended):
        async def run(side):
            sched = side.make(num_pages=8)
            before = _counters(side.metrics)
            await sched.start()
            urgent_tokens = None
            try:
                hog = await sched.submit("hog", hog_prompt, side.greedy(24))
                hog_task = asyncio.create_task(_drain(hog))
                if contended:
                    while hog.generated < 3:
                        await asyncio.sleep(0.002)
                    urgent = await sched.submit("urgent", urgent_prompt, side.greedy(8),
                                                deadline=time.perf_counter() + 60.0)
                    urgent_tokens, uerr = await _drain(urgent)
                    assert uerr is None, uerr
                hog_tokens, herr = await hog_task
                assert herr is None, herr
                sched.allocator.check_invariants()
                assert sched.allocator.used_count == 0
            finally:
                await sched.stop()
            return hog_tokens, urgent_tokens, hog.preempted, _delta(side.metrics, before)
        return run

    clean = _both(models, scenario(False))
    contended = _both(models, scenario(True))
    for name in ("port", "jax"):
        hog_tokens, urgent_tokens, n_pre, delta = contended[name]
        assert n_pre == 1 and delta["finchat_preemptions_total"] == 1
        assert len(urgent_tokens) == 8
        assert hog_tokens == clean[name][0], f"{name}: preemption changed the victim's stream"
    assert contended["port"][3] == contended["jax"][3]
    _assert_teacher_forced(models, hog_prompt, contended["port"][0], contended["jax"][0])
    _assert_teacher_forced(models, urgent_prompt, contended["port"][1], contended["jax"][1])


# --- the circuit breaker ------------------------------------------------------

def test_breaker_trip_through_decode_streams_survive_as_jax(models):
    """``breaker_threshold`` consecutive decode faults trip the breaker: the
    device state is rebuilt, every stream completes as in a fault-free run,
    the rebuild counter rises by one and the breaker closes again."""
    prompts = [list(range(1, 14)), list(range(20, 38))]

    def scenario(fault):
        async def run(side):
            sched = side.make()
            rebuilt = []
            sched.on_rebuild.append(lambda: rebuilt.append(True))
            before = _counters(side.metrics)
            await sched.start()
            try:
                handles = [await sched.submit(f"s{i}", p, side.greedy(10))
                           for i, p in enumerate(prompts)]
                tasks = [asyncio.create_task(_drain(h)) for h in handles]
                if fault:
                    while any(h.generated < 2 for h in handles):
                        await asyncio.sleep(0.002)
                    side.faults.arm("scheduler.decode", side.faults.n_shot(
                        sched.breaker_threshold, RuntimeError("wedged dispatch")))
                results = [await t for t in tasks]
                assert all(err is None for _, err in results), results
                sched.allocator.check_invariants()
                assert sched.allocator.used_count == 0 and len(sched.free_slots) == 2
            finally:
                await sched.stop()
            return ([tokens for tokens, _ in results], bool(rebuilt),
                    _delta(side.metrics, before), side.metrics.get("finchat_breaker_state"))
        return run

    clean = _both(models, scenario(False))
    survived = _both(models, scenario(True))
    keys = ("finchat_engine_rebuilds_total", "finchat_dispatch_failures_total")
    for name in ("port", "jax"):
        tokens, rebuilt, delta, state = survived[name]
        assert not clean[name][1] and rebuilt, f"{name}: on_rebuild never ran"
        assert delta["finchat_engine_rebuilds_total"] == 1 and state == 0
        assert delta["finchat_dispatch_failures_total"] == 3
        assert tokens == clean[name][0], f"{name}: the streams did not survive the rebuild"
    assert ({k: survived["port"][2][k] for k in keys}
            == {k: survived["jax"][2][k] for k in keys})
    for p, got, want in zip(prompts, survived["port"][0], survived["jax"][0]):
        _assert_teacher_forced(models, p, got, want)
    snap = METRICS.snapshot()
    assert snap["finchat_breaker_recovery_seconds_count"] >= 1
    assert snap["finchat_engine_rebuild_seconds_count"] >= 1


def test_breaker_trip_through_mixed_round_as_jax(models):
    """A fault in the packed ragged round (``scheduler.mixed``) at
    ``breaker_threshold`` 1 trips the breaker: the prefilling and the
    decoding row replay after the rebuild, and both streams equal a
    fault-free run."""
    short = list(range(1, 13))
    long = list(range(1, 49))  # 3 chunks of 16

    def scenario(fault):
        async def run(side):
            sched = side.make(breaker_threshold=1)
            before = _counters(side.metrics)
            await sched.start()
            try:
                a = await sched.submit("a", short, side.greedy(8))
                ta = asyncio.create_task(_drain(a))
                while a.generated < 1:  # a decodes before b admits
                    await asyncio.sleep(0.002)
                if fault:
                    side.faults.arm("scheduler.mixed",
                                    side.faults.one_shot(RuntimeError("mixed blip")))
                b = await sched.submit("b", long, side.greedy(8))
                out_b, err_b = await _drain(b)
                out_a, err_a = await ta
                assert err_a is None and err_b is None
            finally:
                await sched.stop()
            return (out_a, out_b, _delta(side.metrics, before),
                    side.metrics.get("finchat_breaker_state"))
        return run

    clean = _both(models, scenario(False))
    faulted = _both(models, scenario(True))
    for name in ("port", "jax"):
        out_a, out_b, delta, state = faulted[name]
        assert delta["finchat_dispatch_failures_total"] == 1, "the mixed site never fired"
        assert delta["finchat_engine_rebuilds_total"] == 1 and state == 0
        assert (out_a, out_b) == clean[name][:2]
    assert faulted["port"][2] == faulted["jax"][2]
    _assert_teacher_forced(models, short, faulted["port"][0], faulted["jax"][0])
    _assert_teacher_forced(models, long, faulted["port"][1], faulted["jax"][1])


def _always_fail(**_ctx):
    raise RuntimeError("dead device")


def test_breaker_gives_up_then_recovers_as_jax(models):
    """A persistent fault does not rebuild forever: after
    ``breaker_max_rebuilds`` trips without a successful round the stream
    fails with the error, and once the fault clears the engine serves."""
    prompt = list(range(1, 14))

    async def run(side):
        sched = side.make(breaker_threshold=2, breaker_max_rebuilds=1)
        gave_up = []
        sched.on_give_up.append(lambda: gave_up.append(True))
        before = _counters(side.metrics)
        await sched.start()
        try:
            side.faults.arm("scheduler.decode", _always_fail)
            doomed = await sched.submit("doomed", prompt, side.greedy(8))
            doomed_tokens, err = await _drain(doomed)
            side.faults.disarm_all()
            healthy = await sched.submit("healthy", prompt, side.greedy(8))
            tokens, err2 = await _drain(healthy)
            assert err2 is None
            sched.allocator.check_invariants()
        finally:
            await sched.stop()
        return (err, len(doomed_tokens), tokens, bool(gave_up), sched.gave_up,
                _delta(side.metrics, before), side.metrics.get("finchat_breaker_state"))

    out = _both(models, run)
    assert out["port"][0] == out["jax"][0] == {"type": "error", "message": "dead device"}
    assert out["port"][1] == out["jax"][1]  # tokens delivered before the give-up
    assert out["port"][3:] == out["jax"][3:]
    assert out["port"][3] and out["port"][4]  # on_give_up ran; gave_up stays until revive
    assert out["port"][5]["finchat_engine_rebuilds_total"] == 1
    assert out["port"][5]["finchat_dispatch_failures_total"] == 4
    assert len(out["port"][2]) == 8
    _assert_teacher_forced(models, prompt, out["port"][2], out["jax"][2])


def test_failed_rebuild_fails_the_replays_and_leaves_the_breaker_open_as_jax(models):
    """The rebuild itself fails: the preempted stream fails with the
    rebuild's error and the breaker stays open; ``revive`` then rebuilds
    the device state, closes the breaker, and the engine serves again."""
    prompt = list(range(1, 14))

    async def run(side):
        sched = side.make(breaker_threshold=1)

        def failing_rebuild():
            raise RuntimeError("device lost")

        real_rebuild = sched.engine.rebuild_device_state
        sched.engine.rebuild_device_state = failing_rebuild
        before = _counters(side.metrics)
        await sched.start()
        try:
            h = await sched.submit("s", prompt, side.greedy(8))
            task = asyncio.create_task(_drain(h))
            while h.generated < 2:
                await asyncio.sleep(0.002)
            side.faults.arm("scheduler.decode", side.faults.one_shot(RuntimeError("wedged")))
            tokens, err = await task
            open_state = side.metrics.get("finchat_breaker_state")
            failed = _delta(side.metrics, before)
            sched.engine.rebuild_device_state = real_rebuild
            revived = await sched.revive_async()
            h2 = await sched.submit("s2", prompt, side.greedy(8))
            tokens2, err2 = await _drain(h2)
            assert err2 is None
            sched.allocator.check_invariants()
        finally:
            await sched.stop()
        return (err, open_state, failed, revived, side.metrics.get("finchat_breaker_state"),
                tokens2)

    out = _both(models, run)
    assert out["port"][0] == out["jax"][0] == {
        "type": "error", "message": "engine rebuild failed: device lost"}
    assert out["port"][1:5] == out["jax"][1:5]
    open_state, failed, revived, closed = out["port"][1:5]
    assert (open_state, revived, closed) == (1, True, 0)
    assert failed["finchat_engine_rebuilds_total"] == 0
    assert failed["finchat_dispatch_failures_total"] == failed["finchat_preemptions_total"] == 1
    _assert_teacher_forced(models, prompt, out["port"][5], out["jax"][5])


def test_revive_after_give_up_as_jax(models):
    """A given-up scheduler is revived: a failed rebuild (``engine.rebuild``
    armed) reports False, the next ``revive_async`` rebuilds the device state, clears
    ``gave_up`` and the breaker, and the engine serves again."""
    prompt = list(range(1, 14))

    async def run(side):
        sched = side.make(breaker_threshold=1, breaker_max_rebuilds=1)
        await sched.start()
        try:
            side.faults.arm("scheduler.decode", _always_fail)
            _tokens, err = await _drain(await sched.submit("doomed", prompt, side.greedy(8)))
            assert err is not None and sched.gave_up
            side.faults.disarm_all()
            before = _counters(side.metrics)
            side.faults.arm("engine.rebuild", side.faults.one_shot(RuntimeError("still dead")))
            first = await sched.revive_async()
            second = await sched.revive_async()
            revived = (first, second, sched.gave_up, side.metrics.get("finchat_breaker_state"),
                       _delta(side.metrics, before))
            tokens, err2 = await _drain(await sched.submit("healthy", prompt, side.greedy(8)))
            assert err2 is None
            assert len(sched.free_slots) == 2
            sched.allocator.check_invariants()
        finally:
            await sched.stop()
        return revived, tokens

    out = _both(models, run)
    assert out["port"][0] == out["jax"][0]
    first, second, gave_up, state, delta = out["port"][0]
    assert (first, second, gave_up, state) == (False, True, False, 0)
    assert delta["finchat_engine_rebuilds_total"] == 1
    _assert_teacher_forced(models, prompt, out["port"][1], out["jax"][1])


# --- deadline admission -------------------------------------------------------

SHED_ERROR = {"type": "error",
              "message": "deadline exceeded before admission; retry with backoff",
              "code": "deadline_exceeded", "retryable": True}


def test_expired_deadline_sheds_with_structured_retryable_error_as_jax(models):
    async def run(side):
        sched = side.make()
        before = _counters(side.metrics)
        await sched.start()
        try:
            h = await sched.submit("late", list(range(1, 14)), side.greedy(8),
                                   deadline=time.perf_counter() - 1.0)
            tokens, err = await _drain(h)
            leaks = (len(sched.free_slots), sched.allocator.used_count)
        finally:
            await sched.stop()
        return tokens, err, leaks, _delta(side.metrics, before)

    out = _both(models, run)
    assert out["port"] == out["jax"]
    tokens, err, leaks, delta = out["port"]
    assert tokens == [] and err == SHED_ERROR and leaks == (2, 0)
    assert delta["finchat_sheds_total"] == 1


def test_edf_order_and_starvation_guard_as_jax(models):
    async def run(side):
        sched = side.make(edf_starvation_seconds=5.0)
        now = time.perf_counter()
        a = await sched.submit("a", [1, 2, 3], side.greedy(4))  # no deadline
        b = await sched.submit("b", [1, 2, 3], side.greedy(4), deadline=now + 50)
        c = await sched.submit("c", [1, 2, 3], side.greedy(4), deadline=now + 5)
        d = await sched.submit("d", [1, 2, 3], side.greedy(4), deadline=now + 20)
        for h in (a, b, c, d):
            h.submitted_at = now
        sched._prepare_pending()
        edf = [h.seq_id for h in sched.pending]
        # a has waited past the guard: it goes ahead of every deadline
        a.submitted_at = now - 10.0
        sched._prepare_pending()
        starved = [h.seq_id for h in sched.pending]
        return edf, starved

    out = _both(models, run)
    assert out["port"] == out["jax"] == (["c", "d", "b", "a"], ["a", "c", "d", "b"])


def test_submit_backpressure_raises_overloaded_as_jax(models):
    async def run(side):
        sched = side.make(max_queue_depth=1)
        before = _counters(side.metrics)
        await sched.submit("q1", [1, 2, 3], side.greedy(4))
        with pytest.raises(side.overloaded) as ei:
            await sched.submit("q2", [1, 2, 3], side.greedy(4))
        return (str(ei.value), ei.value.code, ei.value.retryable, len(sched.pending),
                _delta(side.metrics, before))

    out = _both(models, run)
    assert out["port"] == out["jax"]
    assert out["port"][1:4] == ("overloaded", True, 1)
    assert out["port"][4]["finchat_overload_rejections_total"] == 1


def test_shed_reaches_the_service_caller_as_generation_error(models):
    """A shed request reaches ``LLMService``'s caller as
    ``GenerationError(code="deadline_exceeded", retryable=True)``, as the
    JAX package's ``EngineGenerator`` raises it."""
    sides = _sides(models)
    past = time.perf_counter() - 1.0

    async def port_side():
        sched = sides["port"].make()
        svc = LLMService(EngineGenerator(sched, ByteTokenizer()), "system",
                         SamplingParams(temperature=0.0, max_new_tokens=4))
        await sched.start()
        try:
            with pytest.raises(GenerationError) as ei:
                async for _chunk in svc.process_message("hi", deadline=past):
                    pass
        finally:
            await sched.stop()
        return str(ei.value), ei.value.code, ei.value.retryable

    async def jax_side():
        sched = sides["jax"].make()
        gen = JaxGenerator(sched, JaxTokenizer())
        await sched.start()
        try:
            with pytest.raises(JaxGenerationError) as ei:
                await gen.generate("hi", JaxSampling(temperature=0.0, max_new_tokens=4),
                                   deadline=past)
        finally:
            await sched.stop()
        return str(ei.value), ei.value.code, ei.value.retryable

    got, want = asyncio.run(port_side()), asyncio.run(jax_side())
    assert got == want == (SHED_ERROR["message"], "deadline_exceeded", True)


# --- adopt and shutdown_drain -------------------------------------------------

def test_adopt_honours_the_bound_and_rebinds_the_owner_as_jax(models):
    """A never-admitted handle is plain load: an adopter at
    ``max_queue_depth`` refuses it. A live one (preempted) is always taken,
    at the queue's head, and ``cancel`` through its first scheduler reaches
    the adopter. An adopted live stream is served to its end."""

    async def run(side):
        a = side.make()
        b = side.make(max_queue_depth=2)
        for i in range(2):
            await b.submit(f"b-{i}", list(range(1, 10)), side.greedy(8))
        fresh = await a.submit("fresh", list(range(1, 10)), side.greedy(8))
        refused = (b.adopt(fresh), fresh.owner is a, len(b.pending))
        live = await a.submit("live", list(range(1, 10)), side.greedy(8))
        live.preempted = True
        taken = (b.adopt(live), live.owner is b, b.pending[0] is live)
        a.pending.remove(live)
        a.cancel(live)  # delegates to b
        cancelled = (live.finished, live not in b.pending, live.events.get_nowait())
        # a live stream moved between started schedulers completes there
        c = side.make()
        await c.start()
        try:
            moved = await a.submit("moved", list(range(1, 10)), side.greedy(6))
            a.pending.remove(moved)
            moved.preempted = True
            assert c.adopt(moved)
            tokens, err = await _drain(moved)
            assert err is None
        finally:
            await c.stop()
        return refused, taken, cancelled, tokens

    out = _both(models, run)
    assert out["port"][:3] == out["jax"][:3]
    assert out["port"][:3] == ((False, True, 2), (True, True, True),
                               (True, True, {"type": "done", "reason": "cancelled"}))
    assert len(out["port"][3]) == 6
    _assert_teacher_forced(models, list(range(1, 10)), out["port"][3], out["jax"][3])


SHUTDOWN_ERROR = {"type": "error", "message": "server shutting down; retry with backoff",
                  "code": "shutting_down", "retryable": True}


def test_shutdown_drain_offloads_stragglers_and_leaks_nothing_as_jax(models, tmp_path):
    """``shutdown_drain`` once a stream has 3 tokens (started from its third
    decode dispatch, so no clock decides it): both live streams and the one
    still queued end with the ``shutting_down`` error, the stragglers'
    coherent KV reaches the disk tier, and no slot or page is left."""

    def scenario(name):
        async def run(side):
            sched = side.make(max_seqs=2, session_cache=True,
                              session_cache_disk_path=str(tmp_path / name))
            await sched.start()
            drain: list = []
            handles = [await sched.submit(f"s{i}", list(range(1 + 10 * i, 14 + 10 * i)),
                                          side.greedy(100), conversation_id=f"conv{i}")
                       for i in range(3)]

            def trigger(**_ctx):
                if handles[0].generated >= 3 and not drain:
                    drain.append(asyncio.get_running_loop().create_task(sched.shutdown_drain()))

            side.faults.arm("scheduler.decode", trigger)
            while not drain:
                await asyncio.sleep(0.002)
            await drain[0]
            events = []
            for h in handles:
                evs = []
                while not h.events.empty():
                    evs.append(h.events.get_nowait())
                events.append(evs)
            leaks = (sched.allocator.used_count, len(sched.free_slots), bool(sched.decoding),
                     bool(sched.prefilling), len(sched.pending))
            sched.allocator.check_invariants()
            disk = sched.session_cache.disk
            records = {}
            for h in handles:
                payload = disk.load(h.conversation_id) if h.conversation_id in disk else None
                records[h.seq_id] = None if payload is None else len(payload["token_ids"])
            return ([evs[-1] for evs in events], [h.generated for h in handles], leaks, records,
                    [[e["token_id"] for e in evs if e["type"] == "token"] for evs in events])
        return run

    sides = _sides(models)
    out = {name: asyncio.run(scenario(name)(side)) for name, side in sides.items()}
    last, generated, leaks, records, tokens = out["port"]
    assert last == [SHUTDOWN_ERROR] * 3
    assert generated[2] == 0  # the third never left the queue
    assert leaks == (0, 2, False, False, 0)
    for i, n in enumerate(generated[:2]):
        coherent = ((13 + n - 1) // PAGE) * PAGE
        assert records[f"s{i}"] == coherent, records
    assert records["s2"] is None
    assert out["port"][:4] == out["jax"][:4]
    for i in range(2):
        _assert_teacher_forced(models, list(range(1 + 10 * i, 14 + 10 * i)), tokens[i],
                               out["jax"][4][i])


# --- port only ----------------------------------------------------------------

def test_replay_in_the_same_slot_never_receives_the_stale_token(models):
    """A decode step is in flight when its only member is preempted; the
    replay is re-admitted into the same slot and completes its prefill
    (delivering the next token) before that step is consumed. The stale
    step's token for the slot must be dropped: the handle's epoch moved.
    The stream must equal an uninterrupted run."""
    prompt = list(range(1, 20))
    port = _sides(models)["port"]

    async def clean():
        sched = port.make()
        await sched.start()
        try:
            return (await _drain(await sched.submit("s", prompt, port.greedy(8))))[0]
        finally:
            await sched.stop()

    async def interleaved():
        sched = port.make()  # driven by hand: no loop task
        h = await sched.submit("s", prompt, port.greedy(8))
        sched._admit()
        while sched.prefilling:
            await sched._prefill_round()
        slot = h.slot
        step = sched._dispatch_decode()  # in flight for the first incarnation
        sched._preempt(h)
        sched._admit()
        assert h.slot == slot and h.epoch == 1  # the same slot, a new epoch
        while sched.prefilling:
            await sched._prefill_round()  # the replay delivers the next token
        await sched._consume_step(step)  # stale: nothing may reach the stream
        inflight = None
        while not h.finished:
            nxt = sched._dispatch_decode()
            if inflight is not None:
                await sched._consume_step(inflight)
            inflight = nxt
        tokens = []
        while not h.events.empty():
            ev = h.events.get_nowait()
            if ev["type"] == "token":
                tokens.append(ev["token_id"])
        return tokens, h.history[len(prompt):]

    want = asyncio.run(clean())
    tokens, history = asyncio.run(interleaved())
    assert tokens == want and history == want


def _disk_port(models, path, **over):
    return _sides(models)["port"].make(session_cache=True, session_cache_disk_path=str(path),
                                       **over)


def test_disk_spill_fault_site_never_fails_the_stream(models, tmp_path):
    """``disk.spill`` armed: the record write fails (counted), the retiring
    stream completes, and the RAM entry stays."""
    sched = _disk_port(models, tmp_path / "disk")
    faults.arm("disk.spill", faults.one_shot(RuntimeError("disk full")))
    f0 = METRICS.get("finchat_durability_spill_failures_total")

    async def run():
        await sched.start()
        try:
            return await _drain(await sched.submit("s1", list(range(1, 14)), SamplingParams(
                temperature=0.0, max_new_tokens=8), conversation_id="convF"))
        finally:
            await sched.stop()

    tokens, err = asyncio.run(run())
    sched.session_cache.disk.flush()  # the failure lands on the writer thread
    assert err is None and len(tokens) == 8
    assert METRICS.get("finchat_durability_spill_failures_total") == f0 + 1
    assert "convF" not in sched.session_cache.disk
    assert sched.session_cache.get("convF") is not None


def test_disk_restore_fault_site_quarantines_and_cold_starts(models, tmp_path):
    """``disk.restore`` armed: the record read fails, the record is
    quarantined, and the next turn starts cold (never from stale KV) and
    completes."""
    t1 = list(range(1, 14))
    greedy = SamplingParams(temperature=0.0, max_new_tokens=8)

    async def run():
        sched = _disk_port(models, tmp_path / "disk")
        await sched.start()
        toks1, _ = await _drain(await sched.submit("a-t1", t1, greedy, conversation_id="convR"))
        await sched.stop()
        sched.session_cache.disk.flush()
        sched2 = _disk_port(models, tmp_path / "disk")
        assert "convR" in sched2.session_cache.disk
        faults.arm("disk.restore", faults.one_shot(RuntimeError("read error")))
        q0 = METRICS.get("finchat_durability_quarantines_total")
        await sched2.start()
        try:
            h = await sched2.submit("b-t2", t1 + toks1 + [7, 8, 9], greedy,
                                    conversation_id="convR")
            toks2, err = await _drain(h)
        finally:
            await sched2.stop()
        return h, toks2, err, METRICS.get("finchat_durability_quarantines_total") - q0

    h, toks2, err, quarantined = asyncio.run(run())
    assert err is None and len(toks2) == 8 and h.resumed_len == 0
    assert quarantined == 1 and list((tmp_path / "disk").glob("*.quarantine"))


def test_session_fault_sites_fall_back_without_failing_the_stream(models):
    """``session.offload`` armed: the retiring stream completes and nothing
    is cached. ``session.restore`` armed: the next turn starts cold, and
    no page leaks."""
    greedy = SamplingParams(temperature=0.0, max_new_tokens=8)
    prompt = list(range(1, 20))

    async def run():
        sched = _sides(models)["port"].make(session_cache=True)
        await sched.start()
        try:
            faults.arm("session.offload", faults.one_shot(RuntimeError("D2H failed")))
            t0, err0 = await _drain(await sched.submit("t0", prompt, greedy,
                                                       conversation_id="conv-off"))
            offloaded = sched.session_cache.get("conv-off")
            t1, _ = await _drain(await sched.submit("t1", prompt, greedy,
                                                    conversation_id="conv-res"))
            assert sched.session_cache.get("conv-res") is not None
            faults.arm("session.restore", faults.one_shot(RuntimeError("H2D failed")))
            h2 = await sched.submit("t2", prompt + t1 + list(range(30, 40)), greedy,
                                    conversation_id="conv-res")
            t2, err2 = await _drain(h2)
            sched.allocator.check_invariants()
            return t0, err0, offloaded, t2, err2, h2.resumed_len, sched.allocator.used_count
        finally:
            await sched.stop()

    t0, err0, offloaded, t2, err2, resumed, used = asyncio.run(run())
    assert err0 is None and len(t0) == 8 and offloaded is None
    assert err2 is None and len(t2) == 8 and resumed == 0 and used == 0
