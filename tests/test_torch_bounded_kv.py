"""Bounded KV serving (sink + window eviction) on the port, against the JAX
package's, on CPU at fp32.

The same converted ``tiny`` fp32 weights, and the JAX package's own test
config (``PAGE = 8``, ``CHUNK = 16``, a sink of 1 page and a window of 4: a
5-page budget), serve both packages.

- The port, as tests/test_bounded_kv.py holds the JAX package (its sixteen
  cases that do not need the seq-sharded ring): the policy's math and
  validation, the engine refusing an infeasible policy, streams identical to
  the unbounded ones while the context fits, occupancy bounded over a long
  session, the loop tails and spec composing with eviction, a preempted
  replay equal to the uninterrupted stream and allocating only surviving
  pages, session round trips through RAM and disk, the record fields, a
  gapped entry's whole resume or sink salvage, free-run captures equal to
  host-stepped rounds with eviction on, a gapped entry starting cold on an
  unbounded engine, the env readers and the pre-seeded metrics.
- Against the JAX scheduler on the same prompts (a long session, a
  preempted one, a loop-4 + spec-3 one, three rows prefilling in one
  padded round): the host bookkeeping is exactly
  equal — every row's ``kv_gap`` and ``kv_ctx`` at each wave that evicted,
  the physical pages each wave evicted, the counters' deltas, the final
  gaps — and so are a bounded entry's session record header and bytes.
  The port's streams pass gate (b) against a JAX forward under the bounded
  mask: the served token is the JAX argmax wherever the JAX top-2 margin
  exceeds 1e-3.
- In place: a wave leaves ``state.page_table`` and ``state.kv_gaps`` in
  the storage they had (a captured decode-loop graph reads it).
- The teacher-forcing rule the card check uses: the gap schedule replayed
  on the host from ``BoundedKVPolicy.plan_eviction`` alone (each prefill
  dispatch writes ``min(chunk, remaining)``, each decode dispatch one token,
  past the row's pinned pages) gives each served row's final ``kv_gap``,
  and a dense fp32 forward under the mask it implies gives the port's
  bounded greedy stream. This file keeps its own copy of the rule.
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
from finchat_tpu.engine.kv_cache import BoundedKVPolicy as JaxPolicy  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.engine.session_cache import SessionDiskTier as JaxDiskTier  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JAX_METRICS  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.kv_cache import (  # noqa: E402
    BoundedKVPolicy,
    PageAllocationError,
    pages_needed,
)
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.engine.session_cache import (  # noqa: E402
    SessionDiskTier,
    SessionEntry,
    SessionKVCache,
)
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig, load_config  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

CHUNK = 16
PAGE = 8
SINK, WINDOW = 1, 4  # budget 5 pages = 40 tokens
BUDGET_TOKENS = (SINK + WINDOW) * PAGE
MARGIN = 1e-3
COUNTERS = ("finchat_boundedkv_evicted_pages_total", "finchat_boundedkv_bounded_sessions_total",
            "finchat_boundedkv_recompute_fallbacks_total", "finchat_preemptions_total")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are tiny, and
    the suite runs six workers on the machine's cores, where each worker's
    default thread pool would oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _cfg(*, sink=SINK, window=WINDOW, mixed=True, max_seqs=4, num_pages=128,
         spec_tokens=0, decode_loop_depth=1, freerun_rounds=1, session=False, disk="",
         max_seq_len=512) -> dict:
    """The JAX package's test config (tests/test_bounded_kv.py ``_sched``)."""
    return dict(max_seqs=max_seqs, page_size=PAGE, num_pages=num_pages,
                max_seq_len=max_seq_len, prefill_chunk=CHUNK, mixed_step=mixed,
                session_cache=session, session_cache_bytes=(32 << 20) if session else 0,
                session_cache_disk_path=disk, spec_tokens=spec_tokens,
                decode_loop_depth=decode_loop_depth, freerun_rounds=freerun_rounds,
                kv_sink_pages=sink, kv_window_pages=window)


def _sched(models, *, eos_id=-1, **kw) -> ContinuousBatchingScheduler:
    _jc, _jp, tcfg, tparams = models
    engine = InferenceEngine(tcfg, tparams, EngineConfig(**_cfg(**kw)), device="cpu")
    return ContinuousBatchingScheduler(engine, eos_id=eos_id)


def _jax_sched(models, *, eos_id=-1, **kw) -> JaxScheduler:
    jcfg, jparams, _tc, _tp = models
    engine = JaxEngine(jcfg, jparams, JaxEngineConfig(**_cfg(**kw)), attn_backend="ref")
    return JaxScheduler(engine, eos_id=eos_id)


async def _drain(handle, out):
    while True:
        ev = await asyncio.wait_for(handle.events.get(), timeout=120)
        if ev["type"] == "token":
            out.append(ev["token_id"])
        elif ev["type"] == "done":
            return
        else:
            raise AssertionError(ev)


def _greedy(n, jax_side=False):
    return (JaxSampling if jax_side else SamplingParams)(temperature=0.0, max_new_tokens=n)


def _prompt(models, n, seed=0):
    return np.random.default_rng(seed).integers(1, models[2].vocab_size, size=n).tolist()


def _evicted(metrics=METRICS):
    return metrics.snapshot().get("finchat_boundedkv_evicted_pages_total", 0)


# --- the teacher-forcing rule: the gap schedule replayed on the host ------------


def replay_gaps(policy, prompt_len: int, n_written: int, chunk: int, capacity: int,
                pinned: int) -> tuple[list[int], int, int]:
    """The gap each written position was computed under, from the policy
    alone: a wave before every dispatch, a prefill dispatch writing
    ``min(chunk, remaining)`` tokens and a decode dispatch one. Returns
    ``(gaps of positions [0, n_written), the gap after the last dispatch's
    wave, the gap a further wave would set)`` — a row whose finish lands
    after a wave its next dispatch never followed holds the last."""
    gaps: list[int] = []
    ctx = gap = 0
    while ctx < n_written:
        incoming = min(chunk, prompt_len - ctx) if ctx < prompt_len else 1
        gap += policy.plan_eviction(ctx - gap, incoming, capacity, pinned) * policy.page_size
        gaps += [gap] * incoming
        ctx += incoming
    incoming = min(chunk, prompt_len - ctx) if ctx < prompt_len else 1
    nxt = gap + policy.plan_eviction(ctx - gap, incoming, capacity, pinned) * policy.page_size
    return gaps[:n_written], gap, nxt


def bounded_mask(gaps: list[int], sink_end: int) -> np.ndarray:
    """[S, S] bool: query p sees key j <= p unless j lies in the evicted
    span [sink_end, sink_end + gap_p) of the gap p was computed under."""
    S = len(gaps)
    j = np.arange(S)[None, :]
    p = np.arange(S)[:, None]
    g = np.asarray(gaps)[:, None]
    return (j <= p) & ((j < sink_end) | (j >= sink_end + g))


def _torch_masked_logits(models, ids: list[int], mask: np.ndarray) -> np.ndarray:
    _jc, _jp, tcfg, tparams = models
    m = torch.as_tensor(mask)

    def attention(q, k, v, cache, layer_idx):
        rep = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        p = torch.softmax(s.masked_fill(~m, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v), cache

    toks = torch.as_tensor([ids], dtype=torch.int32)
    pos = torch.arange(len(ids), dtype=torch.int32)[None]
    with torch.no_grad():
        logits, _ = tllama.forward(tparams, toks, pos, config=tcfg, attention=attention)
    return logits[0].numpy()


def _jax_masked_logits(models, ids: list[int], mask: np.ndarray) -> np.ndarray:
    jcfg, jparams, _tc, _tp = models
    m = jnp.asarray(mask)

    def attention(q, k, v, cache, layer_idx):
        rep = q.shape[2] // k.shape[2]
        k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        p = jax.nn.softmax(jnp.where(m, s, -jnp.inf), axis=-1)
        return jnp.einsum("bhqk,bkhd->bqhd", p, v), cache

    toks = jnp.asarray([ids], jnp.int32)
    pos = jnp.arange(len(ids), dtype=jnp.int32)[None]
    logits, _ = jllama.forward(jparams, toks, pos, config=jcfg, attention=attention)
    return np.asarray(logits[0])


def _row_mask(sched, handle, prompt_len: int, n_served: int) -> tuple[np.ndarray, list]:
    """The replayed bounded mask for a served row (prompt + its tokens but
    the last), checking the replay's final gap against the handle's."""
    bp = sched.bounded_kv
    capacity = bp.row_pages(prompt_len + handle.sampling.max_new_tokens)
    pinned = max(bp.sink_pages, handle.shared_len // PAGE)
    written = prompt_len + n_served - 1
    assert written <= handle.kv_ctx <= written + 1, (handle.kv_ctx, written)
    gaps, final, nxt = replay_gaps(bp, prompt_len, handle.kv_ctx, CHUNK, capacity, pinned)
    assert handle.kv_gap in (final, nxt), (handle.kv_gap, final, nxt)
    return bounded_mask(gaps[:written], pinned * PAGE), gaps


def _gate_b(models, sched, handle, prompt, served) -> int:
    """Gate (b) under the bounded mask: wherever the JAX forward's top-2
    margin exceeds 1e-3, the served token is its argmax. Returns how many
    positions were decided."""
    mask, _ = _row_mask(sched, handle, len(prompt), len(served))
    logits = _jax_masked_logits(models, prompt + served[:-1], mask)[len(prompt) - 1:]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > MARGIN
    want = logits.argmax(-1)
    bad = [i for i in range(len(served)) if decided[i] and want[i] != served[i]]
    assert not bad, (handle.seq_id, bad[:4])
    return int(decided.sum())


# --- policy units (pure host math) ----------------------------------------------


def test_policy_eviction_plan_math():
    bp = BoundedKVPolicy(sink_pages=1, window_pages=4, page_size=8)
    assert bp.enabled and bp.budget_pages == 5 and bp.sink_tokens == 8
    assert bp.plan_eviction(30, 8, 5, 1) == 0
    assert bp.plan_eviction(38, 8, 5, 1) == 1
    assert bp.plan_eviction(38, 16, 5, 1) == 2
    assert bp.plan_eviction(38, 8, 5, 2) == 1
    with pytest.raises(PageAllocationError):
        bp.plan_eviction(38, 8, 5, 4)
    assert all(bp.plan_eviction(w, 1, 5, 1) == (1 if (w + 1) > 40 else 0) for w in range(8, 41))
    # the JAX package's policy over a grid: the same plans, the same refusals
    jp = JaxPolicy(sink_pages=1, window_pages=4, page_size=8)
    for ctx in range(0, 64, 3):
        for incoming in (1, 5, 16):
            for cap in (3, 5, 7):
                for pinned in (1, 2, 4):
                    try:
                        want = jp.plan_eviction(ctx, incoming, cap, pinned)
                    except Exception as e:
                        with pytest.raises(PageAllocationError, match="infeasible") as got:
                            bp.plan_eviction(ctx, incoming, cap, pinned)
                        assert str(got.value) == str(e)
                        continue
                    assert bp.plan_eviction(ctx, incoming, cap, pinned) == want
    assert [bp.row_pages(n) for n in range(0, 90, 7)] == [jp.row_pages(n)
                                                          for n in range(0, 90, 7)]


def test_policy_validation():
    with pytest.raises(ValueError, match="dispatch burst"):
        BoundedKVPolicy(1, 2, 8).validate(prefill_chunk=16, max_pages_per_seq=32)
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        BoundedKVPolicy(4, 8, 8).validate(prefill_chunk=16, max_pages_per_seq=8)
    BoundedKVPolicy(0, 0, 8).validate(prefill_chunk=512, max_pages_per_seq=4)
    BoundedKVPolicy(1, 4, 8).validate(prefill_chunk=16, max_pages_per_seq=32)
    # the JAX package's messages, word for word
    for shape, kw in (((1, 2, 8), dict(prefill_chunk=16, max_pages_per_seq=32)),
                      ((4, 8, 8), dict(prefill_chunk=16, max_pages_per_seq=8)),
                      ((1, 3, 8), dict(prefill_chunk=8, max_pages_per_seq=32,
                                       decode_loop_depth=9, spec_tokens=3))):
        with pytest.raises(ValueError) as want:
            JaxPolicy(*shape).validate(**kw)
        with pytest.raises(ValueError) as got:
            BoundedKVPolicy(*shape).validate(**kw)
        assert str(got.value) == str(want.value)


def test_engine_rejects_infeasible_policy(models):
    with pytest.raises(ValueError, match="dispatch burst"):
        _sched(models, sink=1, window=2)


# --- identity while the context fits ------------------------------------------


def _run_single(models, *, prompt, max_new, **kw):
    sched = _sched(models, **kw)
    out: list[int] = []
    peak = {"pages": 0}

    async def go():
        await sched.start()
        try:
            h = await sched.submit("s", prompt, _greedy(max_new))
            task = asyncio.create_task(_drain(h, out))
            while not h.finished:
                peak["pages"] = max(peak["pages"], len(sched.allocator.owned_by("s")))
                await asyncio.sleep(0.001)
            await task
            sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0
            return h
        finally:
            await sched.stop()

    h = asyncio.run(go())
    return out, peak["pages"], sched, h


def test_bounded_identical_while_context_fits(models):
    prompt = _prompt(models, 20, seed=1)
    base, _, _, _ = _run_single(models, sink=0, window=0, prompt=prompt, max_new=12)
    before = _evicted()
    bounded, peak, _, _ = _run_single(models, prompt=prompt, max_new=12)
    assert bounded == base
    assert _evicted() == before, "eviction fired inside the window"
    assert peak <= SINK + WINDOW


def test_long_session_bounded_occupancy_and_envelope(models):
    """Past the budget the row stays at sink + window pages and decodes to
    the end; the stream is the dense forward's under the replayed bounded
    mask (the teacher-forcing rule), and not the plain causal one's."""
    prompt = _prompt(models, 40, seed=2)
    max_new = 40
    before = _evicted()
    out, peak, sched, h = _run_single(models, prompt=prompt, max_new=max_new)
    assert len(out) == max_new
    assert all(0 <= t < models[2].vocab_size for t in out)
    assert peak <= SINK + WINDOW, (peak, "occupancy exceeded the budget")
    assert _evicted() - before >= pages_needed(len(prompt) + max_new, PAGE) - (SINK + WINDOW)
    assert h.kv_gap > 0
    mask, _ = _row_mask(sched, h, len(prompt), len(out))
    ids = prompt + out[:-1]
    logits = _torch_masked_logits(models, ids, mask)[len(prompt) - 1:]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > MARGIN
    assert decided.sum() >= len(out) - 2
    assert all(logits[i].argmax() == out[i] for i in range(len(out)) if decided[i])
    causal = _torch_masked_logits(models, ids, np.tril(np.ones((len(ids),) * 2, bool)))
    assert np.abs(causal[len(prompt) - 1:] - logits).max() > 1e-2, "the mask changed nothing"


def test_bounded_composes_with_loop_tails_and_spec(models):
    prompt = (_prompt(models, 4, seed=3) * 5)[:18]  # repetitive: proposals fire
    snap0 = METRICS.snapshot()
    out, peak, _, _ = _run_single(models, prompt=prompt, max_new=36, spec_tokens=2,
                                  decode_loop_depth=3)
    snap1 = METRICS.snapshot()
    assert len(out) == 36
    assert peak <= SINK + WINDOW
    assert snap1.get("finchat_spec_tokens_accepted_total", 0) > snap0.get(
        "finchat_spec_tokens_accepted_total", 0)


# --- preempt and replay --------------------------------------------------------


def _preempt_when_evicted(sched, h, min_generated: int):
    """Wait until the row has evicted and is at a consumed boundary, then
    preempt it (the page-pressure path's condition: it drains the dispatch
    in flight first)."""
    async def wait():
        for _ in range(100_000):
            if (h.kv_gap > 0 and h.generated >= min_generated
                    and h.kv_gap_pos <= len(h.history) - 1):
                break
            await asyncio.sleep(0.001)
        assert h.kv_gap > 0, "eviction never engaged"
        gap = h.kv_gap
        sched._preempt(h)
        return gap
    return wait()


def test_bounded_preempt_replay_byte_identity(models):
    prompt = _prompt(models, 24, seed=4)
    max_new = 36

    def run(preempt: bool):
        sched = _sched(models)
        out: list[int] = []
        info = {}

        async def go():
            await sched.start()
            try:
                h = await sched.submit("s", prompt, _greedy(max_new))
                task = asyncio.create_task(_drain(h, out))
                if preempt:
                    info["preempted_gap"] = await _preempt_when_evicted(sched, h, 24)
                await task
                sched.allocator.check_invariants()
                info["preempted"] = h.preempted
            finally:
                await sched.stop()

        asyncio.run(go())
        return out, info

    snap0 = METRICS.snapshot()
    clean, _ = run(False)
    replayed, info = run(True)
    snap1 = METRICS.snapshot()
    assert info["preempted"] == 1 and info["preempted_gap"] > 0
    assert replayed == clean, "bounded preempt/replay diverged"
    key = "finchat_boundedkv_recompute_fallbacks_total"
    assert snap1.get(key, 0) == snap0.get(key, 0), "replay recomputed instead of restoring"


def test_bounded_replay_allocates_only_surviving_pages(models):
    prompt = _prompt(models, 24, seed=5)
    sched = _sched(models)

    async def go():
        await sched.start()
        try:
            h = await sched.submit("s", prompt, _greedy(36))
            out: list[int] = []
            task = asyncio.create_task(_drain(h, out))
            for _ in range(100_000):
                if h.kv_gap > 0 and h.generated >= 24:
                    break
                await asyncio.sleep(0.001)
            assert h.kv_gap > 0
            sched._preempt(h)
            assert sched._admission_pages(h) <= SINK + WINDOW
            while h.slot < 0 and not h.finished:
                await asyncio.sleep(0.001)
            assert len(sched.allocator.owned_by("s")) <= SINK + WINDOW
            await task
        finally:
            await sched.stop()

    asyncio.run(go())


# --- the session tier ------------------------------------------------------------


def _two_turn(models, *, disk="", fresh_for_turn2=False):
    """Turn 1 evicts and retires; turn 2 extends the history and resumes.
    Returns (turn 2 tokens, the entry's gap, the metrics window, the turn 2
    handle)."""
    prompt1 = _prompt(models, 24, seed=6)
    sched = _sched(models, session=True, disk=disk)
    t1: list[int] = []
    t2: list[int] = []

    async def turn1():
        await sched.start()
        try:
            h = await sched.submit("s1", prompt1, _greedy(32), conversation_id="conv")
            await _drain(h, t1)
            assert h.kv_gap > 0, "turn 1 never evicted"
        finally:
            await sched.stop()

    asyncio.run(turn1())
    entry = sched.session_cache.get("conv")
    assert entry is not None and entry.kv_gap > 0 and entry.kv_sink == SINK * PAGE
    assert entry.n_tokens % PAGE == 0
    gap = entry.kv_gap
    sched2 = sched
    if fresh_for_turn2:
        sched.session_cache.disk.flush()
        sched2 = _sched(models, session=True, disk=disk)
    prompt2 = prompt1 + t1 + _prompt(models, 6, seed=7)
    snap0 = METRICS.snapshot()

    async def turn2():
        await sched2.start()
        try:
            h = await sched2.submit("s2", prompt2, _greedy(10), conversation_id="conv")
            await _drain(h, t2)
            sched2.allocator.check_invariants()
            return h
        finally:
            await sched2.stop()

    h2 = asyncio.run(turn2())
    snap1 = METRICS.snapshot()
    win = {k: snap1.get(k, 0) - snap0.get(k, 0) for k in (
        "finchat_session_cache_hits_total", "finchat_session_cache_restored_tokens_total",
        "finchat_durability_disk_restores_total")}
    return t2, gap, win, h2


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_session_roundtrip_bounded(models, tmp_path, tier):
    """A bounded entry (its gap in the record header on disk) resumes with
    its sink + window intact: the resumed row starts from the entry's gap."""
    disk = str(tmp_path / "skv") if tier == "disk" else ""
    t2, gap, win, h2 = _two_turn(models, disk=disk, fresh_for_turn2=tier == "disk")
    assert len(t2) == 10
    assert gap > 0
    assert win["finchat_session_cache_hits_total"] == 1
    assert win["finchat_session_cache_restored_tokens_total"] > 0
    assert win["finchat_durability_disk_restores_total"] == (1 if tier == "disk" else 0)
    assert h2.resumed_len > 0 and h2.kv_gap >= gap


def test_bounded_record_serialization_roundtrip():
    """The gap survives the record header, the CRC covers the payload, a
    gap-less record reads as gap 0, and the bytes are the JAX package's."""
    ids = np.arange(48, dtype=np.int32)
    snap_np = (np.ones((2, 3, 8, 4), np.float32), np.ones((2, 3, 8, 4), np.float32), None, None)
    snap = tuple(None if a is None else torch.from_numpy(a) for a in snap_np)
    blob = SessionDiskTier._serialize("k", ids, 8, snap, kv_gap=16, kv_sink=8)
    assert blob == JaxDiskTier._serialize("k", ids, 8, snap_np, kv_gap=16, kv_sink=8)
    out = SessionDiskTier._deserialize(blob)
    assert out["kv_gap"] == 16 and out["kv_sink"] == 8
    assert np.array_equal(out["token_ids"], ids)
    assert torch.equal(out["snap"][0], snap[0])
    bad = bytearray(blob)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        SessionDiskTier._deserialize(bytes(bad))
    legacy = SessionDiskTier._serialize("k", ids, 8, snap)
    assert SessionDiskTier._deserialize(legacy)["kv_gap"] == 0
    assert legacy == JaxDiskTier._serialize("k", ids, 8, snap_np)


def test_gapped_entry_whole_resume_or_sink_salvage():
    def entry(kv_sink=8):
        return SessionEntry(
            conversation_id="c", token_ids=np.arange(1, 41, dtype=np.int32),
            snap=(torch.ones((1, 3, 8, 2)), torch.ones((1, 3, 8, 2)), None, None),
            kv_gap=16, kv_sink=kv_sink)

    cache = SessionKVCache(1 << 20, page_size=8)
    cache.put(entry(), spill=False)
    e, matched = cache.match("c", list(range(1, 41)) + [99, 98])
    assert e is not None and matched == 40 and e.kv_gap == 16
    assert e.own_pages_for(matched, 8) == 3
    e, matched = cache.match("c", list(range(1, 31)))
    assert e is None and matched == 0
    assert cache.get("c") is not None and cache.get("c").kv_gap == 16
    diverged = list(range(1, 41))
    diverged[20] = 999
    e, matched = cache.match("c", diverged + [99])
    assert e is not None and matched == 8
    assert e.kv_gap == 0 and e.n_tokens == 8 and e.snap[0].shape[1] == 1
    cache.put(entry(kv_sink=0), spill=False)
    e, matched = cache.match("c", diverged + [99])
    assert e is None and matched == 0
    assert cache.get("c") is None
    # an over-budget gapped payload is whole or nothing
    payload = {"conversation_id": "c", "token_ids": np.arange(40, dtype=np.int32),
               "prefix_len": 0, "snap": entry().snap, "kv_gap": 16, "kv_sink": 8}
    assert SessionKVCache(64, page_size=8).fit_payload(payload) is None


# --- free-run composition ------------------------------------------------------


def _freerun_workload(models, freerun):
    sched = _sched(models, freerun_rounds=freerun, decode_loop_depth=2, max_seqs=4,
                   num_pages=64)
    rng = np.random.default_rng(11)
    a = rng.integers(1, models[2].vocab_size, size=10).tolist()
    b = rng.integers(1, models[2].vocab_size, size=30).tolist()

    async def go():
        snap0 = METRICS.snapshot()
        await sched.start()
        try:
            ha = await sched.submit("a", a, _greedy(40))
            outs = {"a": [], "b": []}
            tasks = [asyncio.create_task(_drain(ha, outs["a"]))]
            while len(outs["a"]) < 2:
                await asyncio.sleep(0.002)
            hb = await sched.submit("b", b, _greedy(30))
            tasks.append(asyncio.create_task(_drain(hb, outs["b"])))
            await asyncio.gather(*tasks)
            await asyncio.sleep(0.05)
            sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0
            snap1 = METRICS.snapshot()
            win = {k: snap1.get(k, 0) - snap0.get(k, 0) for k in (
                "finchat_freerun_dispatches_total", "finchat_boundedkv_evicted_pages_total",
                'finchat_freerun_capped_total{reason="boundedkv"}')}
            return outs, win
        finally:
            await sched.stop()

    return asyncio.run(go())


def test_freerun_capture_equality_with_eviction(models):
    base, win1 = _freerun_workload(models, 1)
    fr, win4 = _freerun_workload(models, 4)
    assert win1["finchat_boundedkv_evicted_pages_total"] > 0
    assert (win4["finchat_boundedkv_evicted_pages_total"]
            == win1["finchat_boundedkv_evicted_pages_total"])
    assert win4["finchat_freerun_dispatches_total"] >= 1, "captures never engaged"
    assert win4['finchat_freerun_capped_total{reason="boundedkv"}'] >= 1
    assert fr == base


def test_gapped_entry_refused_on_unbounded_engine(models):
    """A gapped entry in an unbounded engine's cache starts cold: nothing
    there can live under its gap."""
    _jc, _jp, tcfg, _tp = models
    sched = _sched(models, sink=0, window=0, session=True)
    prompt = _prompt(models, 40, seed=22)
    entry = SessionEntry(
        conversation_id="conv", token_ids=np.asarray(prompt[:40], np.int32),
        snap=tuple(torch.zeros((tcfg.n_layers, 3, PAGE, tcfg.n_kv_heads * tcfg.head_dim))
                   if i < 2 else None for i in range(4)),
        kv_gap=16, kv_sink=8)
    sched.session_cache.put(entry, spill=False)
    out: list[int] = []

    async def go():
        await sched.start()
        try:
            h = await sched.submit("s", prompt + _prompt(models, 6, seed=23), _greedy(8),
                                   conversation_id="conv")
            await _drain(h, out)
            assert h.kv_gap == 0, "gapped resume leaked onto an unbounded engine"
            sched.allocator.check_invariants()
        finally:
            await sched.stop()

    snap0 = METRICS.snapshot()
    asyncio.run(go())
    snap1 = METRICS.snapshot()
    assert len(out) == 8
    assert (snap1.get("finchat_session_cache_hits_total", 0)
            == snap0.get("finchat_session_cache_hits_total", 0))


# --- config plumbing ------------------------------------------------------------


def test_bounded_kv_env_readers(monkeypatch):
    monkeypatch.setenv("FINCHAT_KV_SINK_PAGES", "3")
    monkeypatch.setenv("FINCHAT_KV_WINDOW_PAGES", "17")
    cfg = load_config()
    assert cfg.engine.kv_sink_pages == 3
    assert cfg.engine.kv_window_pages == 17


def test_boundedkv_metrics_preseeded(models):
    """Every scheduler pre-seeds the family: the gauges show its shape, the
    counters exist from zero (the port's registry has no replica labels)."""
    _jc, _jp, tcfg, tparams = models
    cfg = EngineConfig(max_seqs=2, page_size=PAGE, num_pages=32, max_seq_len=128,
                       prefill_chunk=CHUNK, session_cache=False,
                       kv_sink_pages=SINK, kv_window_pages=WINDOW)
    before = METRICS.snapshot()
    ContinuousBatchingScheduler(InferenceEngine(tcfg, tparams, cfg, device="cpu"), eos_id=-1)
    snap = METRICS.snapshot()
    assert snap.get("finchat_boundedkv_sink_pages") == SINK
    assert snap.get("finchat_boundedkv_window_pages") == WINDOW
    for name in ("finchat_boundedkv_evicted_pages_total",
                 "finchat_boundedkv_bounded_sessions_total",
                 "finchat_boundedkv_recompute_fallbacks_total"):
        assert name in snap and snap[name] == before.get(name, 0)
    ContinuousBatchingScheduler(InferenceEngine(tcfg, tparams, dataclasses.replace(
        cfg, kv_sink_pages=0, kv_window_pages=0), device="cpu"), eos_id=-1)
    snap = METRICS.snapshot()
    assert snap.get("finchat_boundedkv_sink_pages") == 0
    assert snap.get("finchat_boundedkv_window_pages") == 0


# --- against the JAX scheduler ----------------------------------------------------


def _watch_waves(sched, log: list, storage: list | None = None, before_wave=None):
    """Wrap the scheduler's eviction wave: every wave that evicted logs each
    live row's (seq_id, kv_ctx, kv_gap) after it and the physical pages it
    evicted a row. ``storage`` collects the device tensors' addresses
    across each evicting wave; ``before_wave`` runs first (a preempt)."""
    orig = sched._bounded_evict_wave

    def wave():
        if before_wave is not None:
            before_wave()
        rows = [h for h in list(sched.prefilling) + list(sched.decoding.values())
                if h.slot >= 0 and not h.finished]
        before = {h.seq_id: (h.kv_gap, list(h.page_list), sched._bounded_pinned_pages(h))
                  for h in rows}
        st = getattr(sched.engine, "state", None)
        ptrs = None
        if storage is not None:
            ptrs = (st.page_table.data_ptr(), st.kv_gaps.data_ptr())
        orig()
        victims = []
        for h in rows:
            gap0, pages, pin = before[h.seq_id]
            e = (h.kv_gap - gap0) // PAGE
            if e:
                victims.append((h.seq_id, tuple(pages[pin : pin + e])))
        if victims:
            log.append((tuple(sorted((h.seq_id, h.kv_ctx, h.kv_gap) for h in rows)),
                        tuple(sorted(victims))))
            if storage is not None:
                storage.append((ptrs, (sched.engine.state.page_table.data_ptr(),
                                       sched.engine.state.kv_gaps.data_ptr())))

    sched._bounded_evict_wave = wave


def _serve_both(models, jobs, *, preempt_at=None, session=False, sides=("jax", "port"), **kw):
    """Serve ``jobs`` [(seq_id, prompt, max_new)] on each package's scheduler,
    every request submitted before the loop starts (the order of dispatches
    is then the loops' own). ``preempt_at`` (seq_id, kv_ctx) preempts that
    row at the first wave where it has evicted, reached that context and
    stands at a consumed boundary. Returns per package: streams, handles,
    the wave log, counter deltas, the scheduler and the storage log."""
    out = {}
    for side in sides:
        sched = (_jax_sched if side == "jax" else _sched)(models, session=session, **kw)
        metrics = JAX_METRICS if side == "jax" else METRICS
        log: list = []
        storage: list = []
        handles: dict = {}
        fired = []

        def hook(sched=sched, handles=handles, fired=fired):
            if preempt_at is None or fired:
                return
            h = handles.get(preempt_at[0])
            if (h is not None and h.slot >= 0 and h.kv_gap > 0 and h.kv_ctx >= preempt_at[1]
                    and h.kv_gap_pos <= len(h.history) - 1):
                fired.append((h.kv_ctx, h.kv_gap))
                sched._preempt(h)

        _watch_waves(sched, log, storage if side == "port" else None, hook)

        async def go(sched=sched, handles=handles, side=side):
            streams = {}
            for seq_id, prompt, max_new in jobs:
                handles[seq_id] = await sched.submit(
                    seq_id, prompt, _greedy(max_new, jax_side=side == "jax"),
                    conversation_id=f"conv-{seq_id}" if session else None)
                streams[seq_id] = []
            snap0 = metrics.snapshot()
            await sched.start()
            try:
                await asyncio.gather(*(_drain(handles[s], streams[s]) for s in streams))
            finally:
                await sched.stop()
            snap1 = metrics.snapshot()
            sched.allocator.check_invariants()
            assert sched.allocator.used_count == 0
            return streams, {k: snap1.get(k, 0) - snap0.get(k, 0) for k in COUNTERS}

        streams, deltas = asyncio.run(go())
        out[side] = dict(streams=streams, handles=handles, log=log, deltas=deltas,
                         sched=sched, storage=storage, fired=fired)
    return out


def _assert_bookkeeping_equal(res):
    j, p = res["jax"], res["port"]
    assert p["log"] and p["log"] == j["log"]
    assert p["deltas"] == j["deltas"]
    assert p["fired"] == j["fired"]
    for seq_id, h in p["handles"].items():
        hj = j["handles"][seq_id]
        assert (h.kv_gap, h.kv_ctx, h.preempted) == (hj.kv_gap, hj.kv_ctx, hj.preempted)
    # in place: every evicting wave left the table and the gaps where they were
    assert p["storage"] and all(a == b for a, b in p["storage"])


CASES = {
    "long": dict(jobs=[("a", 44, 40, 31), ("b", 20, 36, 32)], kw={}),
    "preempt": dict(jobs=[("s", 24, 36, 4)], kw={}, preempt_at=("s", 50)),
    "loop_spec": dict(jobs=[("r", 18, 36, None), ("q", 30, 28, 33)],
                      kw=dict(decode_loop_depth=4, spec_tokens=3, sink=1, window=4)),
    # three rows prefill together: the round's padding row rides the first
    # row's slot once that slot has evicted
    "three_rows": dict(jobs=[("x", 50, 20, 41), ("y", 65, 20, 42), ("z", 80, 20, 43)],
                       kw=dict(mixed=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bookkeeping_and_streams_match_jax(models, case):
    """The same prompts through both schedulers: the waves, pages, contexts
    and counters exactly equal; the port's streams held by gate (b) under
    the replayed bounded mask; a preempted stream equal to its
    uninterrupted run."""
    spec = CASES[case]
    jobs = []
    for seq_id, n, max_new, seed in spec["jobs"]:
        prompt = ((_prompt(models, 4, seed=3) * 10)[:n] if seed is None
                  else _prompt(models, n, seed=seed))
        jobs.append((seq_id, prompt, max_new))
    res = _serve_both(models, jobs, preempt_at=spec.get("preempt_at"), **spec["kw"])
    _assert_bookkeeping_equal(res)
    p = res["port"]
    assert p["deltas"]["finchat_boundedkv_evicted_pages_total"] > 0
    decided = 0
    for seq_id, prompt, max_new in jobs:
        served = p["streams"][seq_id]
        assert len(served) == max_new and p["handles"][seq_id].kv_gap > 0
        decided += _gate_b(models, p["sched"], p["handles"][seq_id], prompt, served)
    assert decided >= sum(m for _s, _p, m in jobs) // 2
    if case == "preempt":
        assert p["deltas"]["finchat_preemptions_total"] == 1 and p["fired"]
        assert p["deltas"]["finchat_boundedkv_recompute_fallbacks_total"] == 0
        clean = _serve_both(models, jobs, sides=("port",))["port"]["streams"]
        assert p["streams"] == clean
    if case == "loop_spec":
        assert p["sched"].loop_depth == 4 and p["sched"].spec_k == 3


def test_bounded_session_record_matches_jax(models, tmp_path):
    """A bounded entry after one evicting turn: the JAX scheduler's and the
    port's hold the same token ids, head length, gap and sink, the records'
    headers are equal field for field (the payload checksum aside: the KV
    bytes of two frameworks differ by rounding), and the port's record is
    byte-identical to the JAX package's serializer's on the same snapshot."""
    prompt = _prompt(models, 24, seed=6)
    res = _serve_both(models, [("t", prompt, 32)], session=True)
    _assert_bookkeeping_equal(res)
    ej = res["jax"]["sched"].session_cache.get("conv-t")
    ep = res["port"]["sched"].session_cache.get("conv-t")
    assert ej is not None and ep is not None and ep.kv_gap > 0
    assert np.array_equal(ep.token_ids, ej.token_ids)
    assert (ep.prefix_len, ep.kv_gap, ep.kv_sink) == (ej.prefix_len, ej.kv_gap, ej.kv_sink)
    bp = SessionDiskTier._serialize("conv-t", ep.token_ids, ep.prefix_len, ep.snap,
                                    ep.kv_gap, ep.kv_sink)
    bj = JaxDiskTier._serialize("conv-t", ej.token_ids, ej.prefix_len, ej.snap,
                                ej.kv_gap, ej.kv_sink)
    hp, _ = SessionDiskTier._read_header(bp)
    hj, _ = JaxDiskTier._read_header(bj)
    assert {k: v for k, v in hp.items() if k != "crc"} == {k: v for k, v in hj.items()
                                                          if k != "crc"}
    snap_np = tuple(None if a is None else a.numpy() for a in ep.snap)
    assert bp == JaxDiskTier._serialize("conv-t", ep.token_ids, ep.prefix_len, snap_np,
                                        ep.kv_gap, ep.kv_sink)
    for a, b in zip(ep.snap, ej.snap):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
