"""The port's request tracing and flight recorder against the JAX package's,
held against tests/test_tracing.py's cases without the agent or HTTP:

- the ring's bound, the Chrome trace-event schema, a disabled tracer
  recording nothing, and the name registries equal to the JAX sets;
- ``RequestSpan.finish`` first call wins, and a double finish is counted on
  the preempt and drain paths of the real scheduler;
- a ``trace_id`` reaches the dispatch rows through the real generator and
  scheduler, and the greedy output is the same untraced;
- the flight dump's checksummed round trip, corruption detection and
  per-kind rate limit, and the breaker trip's dump;
- the histogram exemplar above p99.

Across packages (CPU, fp32, the converted ``tiny`` weights in both): the
event sequence of one scheduler scenario (name, track, trace id, dispatch
kind and rows; timestamps left out) is equal, and a flight dump written by
either package loads with the other's ``load_flight_dump``.

The device plane: ``named_scope`` is a no-op without a profiler, and
``device_trace`` over a decode step writes a Chrome trace holding the
engine's ``paged_attention`` and ``kv_append`` ranges.
"""

import asyncio
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils import tracing as jtracing  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.generator import EngineGenerator  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils import faults, tracing  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS, MetricsRegistry  # noqa: E402
from finchat_tpu_torch.utils.tracing import (  # noqa: E402
    TRACER,
    RequestSpan,
    Tracer,
    load_flight_dump,
)

torch.set_float32_matmul_precision("highest")

ENGINE = dict(max_seqs=2, page_size=8, num_pages=64, max_seq_len=128, prefill_chunk=16,
              session_cache=False)


@pytest.fixture(autouse=True)
def _tracer_reset():
    """Every test starts from an enabled, dump-less, empty ring in both
    packages; the process tracers are restored afterwards."""
    saved = [(t, t.enabled, t.flight_dir) for t in (TRACER, jtracing.TRACER)]
    for t, _e, _d in saved:
        t.configure(enabled=True, flight_dir="")
        t.clear()
        t._last_dump.clear()
    yield
    for t, enabled, flight_dir in saved:
        t.flush_dumps()
        t.configure(enabled=enabled, flight_dir=flight_dir)
        t.clear()
    faults.disarm_all()


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _port(models, **over):
    _jc, _jp, tcfg, tparams = models
    engine = InferenceEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **over}), device="cpu")
    return ContinuousBatchingScheduler(engine, eos_id=-1)


def _jax(models, **over):
    jcfg, jparams, _tc, _tp = models
    eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **over}), attn_backend="ref")
    return JaxScheduler(eng, eos_id=-1)


def _greedy(n):
    return SamplingParams(temperature=0.0, max_new_tokens=n)


def _names(export):
    return [e["name"] for e in export["traceEvents"]]


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


# --- ring, export, registries -------------------------------------------------

def test_ring_is_bounded():
    t = Tracer(ring_events=32)
    for i in range(100):
        t.event("ingress", f"t{i}")
    assert len(t.snapshot()) == 32
    assert t.export("t0")["traceEvents"] == []
    assert len(t.export("t99")["traceEvents"]) == 1
    t.configure(ring_events=8)  # a resize keeps the newest, 16 at least
    assert [ev[1] for ev in t.snapshot()] == [f"t{i}" for i in range(84, 100)]


def test_export_is_chrome_trace_schema_as_jax():
    for tr in (TRACER, jtracing.TRACER):
        tr.event("ingress", "req-1", ts=1.0, args={"source": "kafka:user_message"})
        tr.event("dispatch", ts=1.5, dur=0.002,
                 args={"kind": "ragged", "n": 7,
                       "rows": [[0, "req-1", "prefill"], [1, "other", "decode"]]})
        tr.event("first_token", "req-1", ts=2.0, track="request")
    export = TRACER.export("req-1")
    assert _names(export) == ["ingress", "dispatch", "first_token"]
    assert export["displayTimeUnit"] == "ms"
    for ev in export["traceEvents"]:
        assert ev["ph"] in ("X", "i")
        assert isinstance(ev["ts"], float) and ev["ts"] > 0
        assert isinstance(ev["tid"], str) and "pid" in ev and "cat" in ev
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        else:
            assert ev["s"] == "t"
    json.dumps(export)
    assert "dispatch" in _names(TRACER.export("other"))
    for tid in ("req-1", "other", "none"):
        assert TRACER.export(tid) == jtracing.TRACER.export(tid)


def test_disabled_tracer_records_nothing(tmp_path):
    TRACER.configure(enabled=False, flight_dir=str(tmp_path))
    TRACER.event("ingress", "t1")
    TRACER.anomaly("shed", "t1")
    with TRACER.span("dispatch"):
        pass
    RequestSpan("s", trace_id="t1").mark("admitted")
    assert TRACER.snapshot() == []
    TRACER.flush_dumps()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("name", ["SPAN_MARKS", "TRACE_EVENTS", "ANOMALY_KINDS",
                                  "TRACE_EVENT_NAMES", "DISPATCH_ROW_MODES", "QUANT_MODES"])
def test_registries_equal_the_jax_sets(name):
    assert getattr(tracing, name) == getattr(jtracing, name)


def test_span_context_records_a_complete_event():
    with TRACER.span("dispatch", "req-s", args={"kind": "decode", "rows": []}):
        pass
    (ev,) = TRACER.export("req-s")["traceEvents"]
    assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["args"]["kind"] == "decode"


# --- spans ------------------------------------------------------------------------

def test_span_finish_first_call_wins():
    reg = MetricsRegistry()
    span = RequestSpan("seq-1", trace_id="t-span")
    span.mark("admitted")
    span.finish(reg)
    done = span.marks["done"]
    n0 = reg.snapshot()["finchat_request_seconds_count"]
    span.finish(reg)
    span.finish(reg)
    assert span.marks["done"] == done
    assert reg.snapshot()["finchat_request_seconds_count"] == n0
    assert reg.get("finchat_span_double_finish_total") == 2
    assert reg.exemplar("finchat_request_seconds")[0] == "t-span"
    assert _names(TRACER.export("t-span")) == ["admitted", "done", "request"]


def test_double_finish_counted_on_preempt_and_drain_paths(models):
    """A preempted stream failed by ``shutdown_drain`` is finished there
    first; a late ``_finish`` and ``span.finish`` only count."""
    d0 = METRICS.get("finchat_span_double_finish_total")
    n0 = METRICS.snapshot().get("finchat_request_seconds_count", 0)

    async def go():
        sched = _port(models)
        await sched.start()
        try:
            h = await sched.submit("s0", list(range(1, 14)), _greedy(32), trace_id="req-drain")
            while h.generated < 2:
                await asyncio.sleep(0.002)
            sched._preempt(h)
            assert h.preempted == 1 and not h.finished
        finally:
            await sched.shutdown_drain()
        assert h.finished and h.span.finished
        sched._finish(h, "eos")
        h.span.finish()
        return h

    h = asyncio.run(go())
    assert METRICS.get("finchat_span_double_finish_total") - d0 == 2
    assert METRICS.snapshot()["finchat_request_seconds_count"] - n0 == 1
    names = _names(TRACER.export("req-drain"))
    assert names.count("preempt") == 1 and names.count("request") == 1


def test_trace_threads_through_the_generator_and_is_output_invariant(models):
    """One traced request through the real generator and scheduler: its
    timeline holds admitted, the prefill and decode dispatches that carried
    it, first_token, done and the request span; every dispatch row that
    names it was booked by the scheduler; the greedy text equals the
    untraced run's."""
    tok = ByteTokenizer()
    prompt = "User: how much did I spend on coffee last month?"

    def run(traced: bool):
        TRACER.configure(enabled=traced)
        TRACER.clear()

        async def go():
            sched = _port(models)
            booked = []
            trace_dispatch = sched._trace_dispatch

            def booking(kind, rows, **k):
                booked.append((kind, [r[2] for r in rows if r[1] == "req-42"]))
                trace_dispatch(kind, rows, **k)

            sched._trace_dispatch = booking
            gen = EngineGenerator(sched, tok)
            await sched.start()
            try:
                text = await gen.generate(prompt, _greedy(8),
                                          trace_id="req-42" if traced else None)
            finally:
                await sched.stop()
            return text, [b for b in booked if b[1]]

        return asyncio.run(go())

    text_on, booked = run(True)
    export = TRACER.export("req-42")
    names = _names(export)
    for expected in ("admitted", "prefill_done", "first_token", "done", "request", "dispatch"):
        assert expected in names, (expected, names)
    dispatches = [e for e in export["traceEvents"] if e["name"] == "dispatch"]
    modes = [r[2] for e in dispatches for r in e["args"]["rows"] if r[1] == "req-42"]
    assert {"prefill", "decode"} <= set(modes)
    assert len(dispatches) == len(booked)
    assert modes == [m for _k, ms in booked for m in ms]
    assert all(e["args"]["quant"] == "bf16" for e in dispatches)
    text_off, booked_off = run(False)
    assert booked_off == [] and TRACER.snapshot() == []
    assert text_on == text_off


def test_event_sequence_of_a_scheduler_scenario_equals_jax(models):
    """Two traced requests queued before the loop starts (one prompt of one
    chunk, one of two): a prefill round that completes the first, its
    decode step, a ragged round that completes the second beside it, then
    the pipelined decode. Both packages record the same events in the same
    order."""

    def run(make, tr):
        tr.configure(enabled=True)
        tr.clear()

        async def go():
            sched = make(models)
            greedy = _greedy if make is _port else (
                lambda n: JaxSampling(temperature=0.0, max_new_tokens=n))
            a = await sched.submit("a", list(range(1, 14)), greedy(6), trace_id="ta")
            b = await sched.submit("b", list(range(40, 70)), greedy(5), trace_id="tb")
            await sched.start()
            try:
                out = [await _drain(a), await _drain(b)]
            finally:
                await sched.stop()
            return out

        out = asyncio.run(go())
        events = []
        for ts, tid, name, dur, track, args in tr.snapshot():
            row = (name, track, tid)
            if name == "dispatch":
                row += (args["kind"], args["n"], args["quant"],
                        tuple(tuple(r) for r in args["rows"]))
            events.append(row)
        return out, events

    t_out, t_events = run(_port, TRACER)
    j_out, j_events = run(_jax, jtracing.TRACER)
    assert [err for _t, err in t_out] == [None, None]
    assert t_events == j_events
    kinds = [e[3] for e in t_events if e[0] == "dispatch"]
    assert kinds[:3] == ["prefill", "decode", "ragged"] and kinds[-1] == "decode"


# --- the flight recorder -----------------------------------------------------------

def test_flight_dump_checksummed_roundtrip(tmp_path):
    TRACER.configure(flight_dir=str(tmp_path))
    TRACER.event("dispatch", args={"kind": "decode", "n": 3, "rows": [[0, "req-9", "decode"]]})
    TRACER.anomaly("breaker_trip", args={"plane": "decode", "error": "wedged"})
    TRACER.flush_dumps()
    dumps = sorted(tmp_path.glob("flight-*.json"))
    assert len(dumps) == 1 and "breaker_trip" in dumps[0].name
    rec = load_flight_dump(str(dumps[0]))
    assert rec["reason"] == "breaker_trip"
    assert [e["name"] for e in rec["trace"]["traceEvents"]] == ["dispatch", "breaker_trip"]
    assert rec["anomaly_args"]["plane"] == "decode"
    assert METRICS.get("finchat_flight_dumps_total", labels={"reason": "breaker_trip"}) >= 1


def test_flight_dump_corruption_detected(tmp_path):
    TRACER.configure(flight_dir=str(tmp_path))
    TRACER.anomaly("shed")
    TRACER.flush_dumps()
    path = next(tmp_path.glob("flight-*.json"))
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        load_flight_dump(str(path))
    path.write_bytes(path.read_bytes()[:-10])
    with pytest.raises(ValueError, match="truncated"):
        load_flight_dump(str(path))
    path.write_bytes(b"NOT-A-DUMP v0\n{}")
    with pytest.raises(ValueError, match="magic"):
        load_flight_dump(str(path))


def test_flight_dump_rate_limited_per_kind(tmp_path):
    TRACER.configure(flight_dir=str(tmp_path))
    for _ in range(5):
        TRACER.anomaly("shed")
    TRACER.anomaly("watchdog_timeout")
    TRACER.flush_dumps()
    names = [p.name for p in tmp_path.glob("flight-*.json")]
    assert len([n for n in names if "shed" in n]) == 1
    assert len([n for n in names if "watchdog_timeout" in n]) == 1
    assert sum(1 for ev in TRACER.snapshot() if ev[2] == "shed") == 5


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flight_dump_loads_across_packages(tmp_path, writer):
    tr = TRACER if writer == "port" else jtracing.TRACER
    tr.configure(flight_dir=str(tmp_path))
    tr.event("dispatch", ts=3.0, dur=0.01,
             args={"kind": "ragged", "n": 1, "rows": [[1, "req-x", "constrained"]]})
    tr.anomaly("record_quarantine", "req-x", args={"key": "conv-1", "file": "f.rec"})
    tr.flush_dumps()
    (path,) = tmp_path.glob("flight-*.json")
    mine = load_flight_dump(str(path)) if writer == "port" else \
        jtracing.load_flight_dump(str(path))
    other = jtracing.load_flight_dump(str(path)) if writer == "port" else \
        load_flight_dump(str(path))
    assert mine == other
    assert other["reason"] == "record_quarantine" and other["trace_id"] == "req-x"
    assert [e["name"] for e in other["trace"]["traceEvents"]] == ["dispatch",
                                                                   "record_quarantine"]


def test_breaker_trip_dumps_flight_recorder(models, tmp_path):
    """The breaker trip leaves a black box holding the trip, the dispatches
    that carried the tripped request, and its recovery preempt."""
    TRACER.configure(flight_dir=str(tmp_path))

    async def go():
        sched = _port(models)
        await sched.start()
        try:
            h = await sched.submit("s0", list(range(1, 14)), _greedy(10), trace_id="req-trip")
            task = asyncio.create_task(_drain(h))
            while h.generated < 2:
                await asyncio.sleep(0.002)
            faults.arm("scheduler.decode", faults.n_shot(
                sched.breaker_threshold, RuntimeError("chaos: wedged dispatch")))
            tokens, err = await task
            assert err is None and len(tokens) == 10
        finally:
            await sched.stop()
            faults.disarm_all()

    asyncio.run(go())
    TRACER.flush_dumps()
    dumps = [p for p in tmp_path.glob("flight-*.json") if "breaker_trip" in p.name]
    assert len(dumps) == 1
    rec = load_flight_dump(str(dumps[0]))
    assert jtracing.load_flight_dump(str(dumps[0])) == rec
    events = rec["trace"]["traceEvents"]
    assert any(e["name"] == "breaker_trip" for e in events)
    assert any(e["name"] == "dispatch" and any(r[1] == "req-trip" for r in e["args"]["rows"])
               for e in events)
    assert any(e["name"] == "preempt" for e in events
               if e["args"].get("trace_id") == "req-trip")


def test_shed_and_quarantine_are_anomalies(models, tmp_path):
    """A deadline shed records the ``shed`` anomaly on the request and
    dumps; a corrupt session record's quarantine dumps too."""
    import time

    from finchat_tpu_torch.engine.session_cache import SessionDiskTier

    TRACER.configure(flight_dir=str(tmp_path / "flight"))

    async def go():
        sched = _port(models)
        h = await sched.submit("late", list(range(1, 9)), _greedy(4), trace_id="req-shed",
                               deadline=time.perf_counter() - 1.0)
        await sched.start()
        try:
            return await _drain(h)
        finally:
            await sched.stop()

    _tokens, err = asyncio.run(go())
    assert err["code"] == "deadline_exceeded"
    assert "shed" in _names(TRACER.export("req-shed"))
    disk = SessionDiskTier(str(tmp_path / "disk"), 1 << 20, metrics=MetricsRegistry())
    disk._quarantine("conv-bad")
    disk.close()
    TRACER.flush_dumps()
    kinds = sorted(p.name.split("-", 2)[2] for p in (tmp_path / "flight").glob("flight-*"))
    assert kinds == ["record_quarantine.json", "shed.json"]


# --- exemplars ---------------------------------------------------------------------

def test_histogram_exemplar_tracks_above_p99():
    reg = MetricsRegistry()
    for i in range(200):
        reg.observe("finchat_lat_seconds", 0.01, trace_id=f"fast-{i}")
    reg.observe("finchat_lat_seconds", 9.0, trace_id="slow-1")
    for i in range(50):
        reg.observe("finchat_lat_seconds", 0.01, trace_id=f"tail-{i}")
    tid, value, _ts = reg.exemplar("finchat_lat_seconds")
    assert tid == "slow-1" and value == 9.0
    assert reg.quantile("finchat_lat_seconds", 0.5) == 0.01
    assert reg.quantile("finchat_lat_seconds", 1.0) == 10.0
    assert reg.exemplar("finchat_missing_seconds") is None
    assert reg.quantile("finchat_missing_seconds", 0.5) == 0.0


# --- the device plane --------------------------------------------------------------

def test_named_scope_is_a_no_op_without_a_profiler():
    assert tracing.named_scope("paged_attention") is tracing.named_scope("kv_append")


def test_device_trace_holds_the_engines_ranges(models, tmp_path):
    """``device_trace`` over a prefill chunk and a decode step writes a
    Chrome trace with the ``kv_scatter``, ``kv_append`` and
    ``paged_attention`` ranges of every layer."""
    sched = _port(models)
    eng = sched.engine
    eng.set_page_table_rows({0: [1, 2]})
    with tracing.device_trace(str(tmp_path)):
        eng.prefill_chunk([[5] * 16], [0], [0], [9])
        eng.decode([True, False], [0.0, 0.0], [1.0, 1.0], [0, 0])
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    n_layers = eng.config.n_layers
    assert names.count("kv_scatter") == n_layers
    assert names.count("kv_append") == n_layers
    assert names.count("paged_attention") == 2 * n_layers
