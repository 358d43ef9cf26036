"""The port's session KV cache (engine/session_cache.py) against the JAX
package's, on CPU.

Held on the port, as the JAX package's tests/test_session_cache.py,
tests/test_durability.py and tests/test_quant_serving.py hold it there:

- a resumed turn streams the greedy tokens a cold run of the same prompt
  streams, and skips the matched tokens' prefill; a divergent history is
  truncated to the matched pages; a failed restore frees its pages and the
  stream starts cold; cancelled streams are not offloaded; the RAM tier
  evicts least recently used entries under its byte budget; entries
  reference the shared head's pages and snapshot only their own; a later
  turn copies to the host only the pages it wrote;
- the disk tier: FSKV v2 records round-trip byte for byte (bf16 and int8
  with its scale planes), version 1 stays readable, the tier's LRU keeps
  its budget, the startup sweep deletes orphans and quarantines bad
  records, a corrupt record or a failed read quarantines and the turn
  starts cold, a failed write never fails a stream, a record of the other
  KV mode is set aside, an over-budget record resumes partly, a restarted
  scheduler resumes from disk as deep as the RAM tier would, a closed tier
  writes inline; a bounded-KV entry (the JAX package's ``kv_gap``) is
  refused at import, from a payload or a disk record, and the turn starts
  cold.

Across packages: a record serializes to the same bytes in both and each
reads the other's; a JAX ``gather_pages_host`` snapshot restored into the
port's pool and offloaded back is bit-identical; on the same turns the two
schedulers resume the same tokens with the same page accounting and stream
greedy tokens under the teacher-forced contract.

Port-against-port greedy comparisons (warm against cold) require equal
token streams, as the JAX package's tests do.
"""

import asyncio
import dataclasses
import json
import threading

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finchat_tpu.engine import kv_cache as jkv  # noqa: E402
from finchat_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from finchat_tpu.engine.sampler import SamplingParams as JaxSampling  # noqa: E402
from finchat_tpu.engine.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from finchat_tpu.engine.session_cache import SessionDiskTier as JaxDiskTier  # noqa: E402
from finchat_tpu.models import llama as jllama  # noqa: E402
from finchat_tpu.utils.config import EngineConfig as JaxEngineConfig  # noqa: E402
from finchat_tpu_torch.engine import kv_cache as tkv  # noqa: E402
from finchat_tpu_torch.engine.engine import InferenceEngine  # noqa: E402
from finchat_tpu_torch.engine.kv_cache import PageAllocationError, PageAllocator  # noqa: E402
from finchat_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler  # noqa: E402
from finchat_tpu_torch.engine.session_cache import (  # noqa: E402
    SessionDiskTier,
    conversation_of,
    resolve_dtype,
    session_key,
    snap_kv_mode,
)
from finchat_tpu_torch.models import llama as tllama  # noqa: E402
from finchat_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from finchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from finchat_tpu_torch.utils.config import EngineConfig  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS  # noqa: E402

torch.set_float32_matmul_precision("highest")

PAGE = 8
MARGIN = 1e-3
ENGINE = dict(max_seqs=4, page_size=PAGE, num_pages=128, max_seq_len=256, prefill_chunk=16,
              preemption=False, breaker_threshold=0)
HEAD = "system: you are a terse financial assistant, answer briefly."


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.PRESETS["tiny"], dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams), "cpu")


def _cfg(session_bytes=64 << 20, disk_path=None, disk_bytes=64 << 20, **over) -> dict:
    return {**ENGINE, "session_cache": session_bytes > 0,
            "session_cache_bytes": max(session_bytes, 1),
            "session_cache_disk_path": str(disk_path) if disk_path else "",
            "session_cache_disk_bytes": disk_bytes, **over}


def _port(models, eos_id=None, **kw) -> ContinuousBatchingScheduler:
    _jc, _jp, tcfg, tparams = models
    eng = InferenceEngine(tcfg, tparams, EngineConfig(**_cfg(**kw)), device="cpu")
    return ContinuousBatchingScheduler(eng, eos_id=ByteTokenizer().eos_id if eos_id is None
                                       else eos_id)


def _jax(models, eos_id=None, **kw) -> JaxScheduler:
    jcfg, jparams, _tc, _tp = models
    eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**_cfg(**kw)), attn_backend="ref")
    return JaxScheduler(eng, eos_id=ByteTokenizer().eos_id if eos_id is None else eos_id)


async def _collect(sched, seq_id, prompt_ids, n_new, conversation_id=None, jax_side=False):
    sampling = (JaxSampling if jax_side else SamplingParams)(temperature=0.0,
                                                             max_new_tokens=n_new)
    handle = await sched.submit(seq_id, prompt_ids, sampling, conversation_id=conversation_id)
    tokens = []
    while True:
        event = await asyncio.wait_for(handle.events.get(), timeout=120)
        if event["type"] == "token":
            tokens.append(event["token_id"])
        elif event["type"] == "done":
            return handle, tokens
        else:
            raise AssertionError(event)


def _run_turns(sched, turns, conversation_id, n_new=8):
    """Serve prompts as sequential turns of one conversation; returns the
    handles and token lists."""

    async def run():
        await sched.start()
        try:
            return [await _collect(sched, f"{conversation_id}-t{i}", p, n_new,
                                   conversation_id=conversation_id)
                    for i, p in enumerate(turns)]
        finally:
            await sched.stop()

    return asyncio.run(run())


def _assert_teacher_forced(models, prompt, got, want):
    """The port's greedy stream ``got`` and the JAX package's ``want`` of one
    prompt are equal up to their first difference, and there the JAX
    package's plain forward has a top-2 margin within 1e-3."""
    jcfg, jparams, _tc, _tp = models
    assert got and want
    n = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if n is None:
        assert len(got) == len(want)
        return
    ids = prompt + want[:n]
    x = jnp.asarray([ids], jnp.int32)
    logits = np.asarray(jllama.forward_full(jparams, x, jnp.arange(len(ids))[None],
                                            config=jcfg, attn_backend="ref"))[0, -1]
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] <= MARGIN, (n, got[n], want[n], top2)


def _bf16(a: np.ndarray) -> torch.Tensor:
    """An ml_dtypes bfloat16 array as a torch tensor, bit for bit."""
    return torch.from_numpy(np.array(a).view(np.uint16).view(np.int16)).view(torch.bfloat16)


def _to_torch(snap: tuple) -> tuple:
    return tuple(None if a is None else (_bf16(a) if a.dtype == ml_dtypes.bfloat16
                                         else torch.from_numpy(np.array(a))) for a in snap)


def _raw(t: torch.Tensor | None) -> bytes | None:
    if t is None:
        return None
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _np_raw(a: np.ndarray | None) -> bytes | None:
    return None if a is None else np.ascontiguousarray(a).tobytes()


# --- keys ------------------------------------------------------------------

def test_session_key_roundtrip():
    assert session_key("c1", "resp") == "c1#resp"
    assert conversation_of(session_key("c1", "tool")) == "c1"
    assert conversation_of("c#x") == "c#x" and conversation_of("plain") == "plain"


@pytest.mark.parametrize("name,want", [("bfloat16", torch.bfloat16), ("float32", torch.float32),
                                       ("int8", torch.int8), ("<f4", torch.float32),
                                       ("|i1", torch.int8)])
def test_resolve_dtype(name, want):
    assert resolve_dtype(name) == want


def test_resolve_dtype_refuses_unknown_names():
    with pytest.raises(ValueError):
        resolve_dtype("<V2")  # a version-1 bf16 record: unreadable by design
    with pytest.raises(ValueError):
        resolve_dtype("load")


# --- cross-turn resume on the port -----------------------------------------

def test_turn_resume_is_golden_and_skips_prefill(models):
    tok = ByteTokenizer()
    p1 = tok.encode(HEAD + " q1: how much did I spend?", add_bos=True)
    warm = _port(models)
    hits0 = METRICS.get("finchat_session_cache_hits_total")
    restored0 = METRICS.get("finchat_session_cache_restored_tokens_total")

    async def run_warm():
        await warm.start()
        try:
            _, t1 = await _collect(warm, "t1", p1, 8, conversation_id="c1")
            assert len(warm.session_cache) == 1  # retirement offloaded
            p2 = p1 + t1 + tok.encode(" q2: and last week?", add_bos=False)
            h2, t2 = await _collect(warm, "t2", p2, 8, conversation_id="c1")
            return t1, p2, t2, h2
        finally:
            await warm.stop()

    t1, p2, t2, h2 = asyncio.run(run_warm())
    assert METRICS.get("finchat_session_cache_hits_total") == hits0 + 1
    matched = METRICS.get("finchat_session_cache_restored_tokens_total") - restored0
    # the whole first turn (prompt + response minus the uncached last
    # token) is floored to pages and resumed
    assert matched == ((len(p1) + len(t1) - 1) // PAGE) * PAGE > 0
    assert h2.resumed_len == matched
    warm.allocator.check_invariants()
    assert warm.allocator.used_count == 0  # only host copies remain

    cold = _port(models, session_bytes=0)
    assert cold.session_cache is None
    (_, t2_cold), = _run_turns(cold, [p2], "c1")
    assert t2 == t2_cold


def test_divergent_history_truncates_to_matched_prefix(models):
    tok = ByteTokenizer()
    p1 = tok.encode(HEAD + " q1: list my biggest purchases please", add_bos=True)
    sched = _port(models)
    trunc0 = METRICS.get("finchat_session_cache_truncations_total")
    restored0 = METRICS.get("finchat_session_cache_restored_tokens_total")
    keep = (len(p1) // 2 // PAGE) * PAGE  # the divergence point, page-aligned
    p2 = p1[:keep] + tok.encode("completely different history tail now", add_bos=False)

    (_, _), (h2, t2_warm) = _run_turns(sched, [p1, p2], "c-div")
    entry = sched.session_cache.get("c-div")
    assert METRICS.get("finchat_session_cache_truncations_total") == trunc0 + 1
    # the resume restored exactly the shared whole-page prefix
    assert METRICS.get("finchat_session_cache_restored_tokens_total") - restored0 == keep
    assert h2.resumed_len == keep
    # the re-offloaded turn-2 entry covers turn 2's stream, not the old tail
    assert entry is not None and list(entry.token_ids[:keep]) == p2[:keep]
    (_, t2_cold), = _run_turns(_port(models, session_bytes=0), [p2], "c-div")
    assert t2_warm == t2_cold


def test_offloaded_then_freed_pages_cannot_be_double_freed(models):
    tok = ByteTokenizer()
    p1 = tok.encode(HEAD + " q: status?", add_bos=True)
    sched = _port(models)
    (handle, _), = _run_turns(sched, [p1], "c")
    sched.allocator.check_invariants()
    assert len(sched.session_cache) == 1
    assert handle.page_list  # pages were recorded at admission...
    with pytest.raises(PageAllocationError):  # ...and freed exactly once
        sched.allocator.free(handle.seq_id, handle.page_list)
    # the host snapshot survives reuse of those device pages
    entry = sched.session_cache.get("c")
    snap_k = entry.snap[0].clone()
    reused = sched.allocator.allocate("other", len(handle.page_list))
    sched.engine.state.k_pages[:, reused] = 7.0
    assert torch.equal(entry.snap[0], snap_k)
    sched.allocator.free("other", reused)


def test_restore_failure_frees_cleanly_and_falls_back_cold(models):
    tok = ByteTokenizer()
    p1 = tok.encode(HEAD + " q1: how much did I spend?", add_bos=True)
    sched = _port(models)
    boom = {"raised": 0}
    real_restore = sched.engine.restore_pages

    def failing_restore(page_ids, host):
        boom["raised"] += 1
        raise RuntimeError("injected restore failure")

    misses0 = METRICS.get("finchat_session_cache_misses_total")

    async def run():
        await sched.start()
        try:
            _, t1 = await _collect(sched, "t1", p1, 8, conversation_id="c")
            p2 = p1 + t1 + tok.encode(" q2?", add_bos=False)
            sched.engine.restore_pages = failing_restore
            try:
                h2, t2 = await _collect(sched, "t2", p2, 8, conversation_id="c")
            finally:
                sched.engine.restore_pages = real_restore
            return p2, h2, t2
        finally:
            await sched.stop()

    p2, h2, t2 = asyncio.run(run())
    assert boom["raised"] == 1  # the resume was attempted
    assert h2.resumed_len == 0 and h2.prefill_pos == len(p2)
    assert METRICS.get("finchat_session_cache_misses_total") == misses0 + 2
    sched.allocator.check_invariants()
    assert sched.allocator.used_count == 0  # nothing leaked
    (_, t2_cold), = _run_turns(_port(models, session_bytes=0), [p2], "c")
    assert t2 == t2_cold


def test_lru_eviction_under_byte_budget(models):
    tok = ByteTokenizer()
    p = tok.encode(HEAD + " q1: how much did I spend overall?", add_bos=True)
    probe = _port(models)
    _run_turns(probe, [p], "c0")
    one_entry = probe.session_cache.get("c0").nbytes
    assert one_entry > 0
    # a budget for two entries: the third insert evicts the LRU conversation
    sched = _port(models, session_bytes=2 * one_entry)
    ev0 = METRICS.get("finchat_session_cache_evictions_total")
    for i in range(3):
        _run_turns(sched, [p], f"c{i}")
    cache = sched.session_cache
    assert METRICS.get("finchat_session_cache_evictions_total") == ev0 + 1
    assert cache.get("c0") is None  # least recently used went first
    assert cache.get("c1") is not None and cache.get("c2") is not None
    assert cache.resident_bytes <= cache.budget_bytes
    assert METRICS.get("finchat_session_cache_resident_bytes") == cache.resident_bytes


def test_composes_with_shared_prefix_head(models):
    tok = ByteTokenizer()
    sched = _port(models)
    head_ids = tok.encode(HEAD, add_bos=True)
    shared = sched.register_prefix(head_ids)
    assert shared > 0
    prefix_pages = sched.allocator.used_count

    p1 = head_ids + tok.encode(" q1: what changed?", add_bos=False)
    (_, t1), = _run_turns(sched, [p1], "c")
    entry = sched.session_cache.get("c")
    # the head rode the shared-prefix entry: referenced, never copied
    assert entry.prefix_len == shared
    assert entry.prefix_entry is sched._prefixes[0]
    assert entry.prefix_entry.refs == 1  # held by the session entry
    own_pages = (((len(p1) + len(t1) - 1) // PAGE) * PAGE - shared) // PAGE
    assert entry.snap[0].shape[1] == own_pages  # the host copy excludes the head
    assert sched.allocator.used_count == prefix_pages  # device: the head only

    # a resumed turn references the head pages while the head is live
    p2 = p1 + t1 + tok.encode(" q2: and now?", add_bos=False)
    hits0 = METRICS.get("finchat_session_cache_hits_total")
    (h2, t2_warm), = _run_turns(sched, [p2], "c")
    assert METRICS.get("finchat_session_cache_hits_total") == hits0 + 1
    assert h2.shared_len == shared and h2.page_list[: shared // PAGE] == sched._prefixes[0].pages
    assert sched.allocator.used_count == prefix_pages
    (_, t2_cold), = _run_turns(_port(models, session_bytes=0), [p2], "c")
    assert t2_warm == t2_cold

    # retirement drops entries referencing the retired head, and its pages
    # free at once
    sched.retire_prefixes()
    assert len(sched.session_cache) == 0
    sched.allocator.check_invariants()
    assert sched.allocator.used_count == 0
    assert sched._prefixes == []


def test_incremental_offload_reuses_prior_snapshot(models):
    """Turn N's retirement copies to the host only the pages written THIS
    turn; pages restored at admission reuse the previous entry's bytes.
    No EOS (``eos_id=-1``): every turn runs its full ``n_new`` tokens, which
    the page arithmetic below counts on."""
    tok = ByteTokenizer()
    sched = _port(models, eos_id=-1)
    p1 = tok.encode(HEAD + " q1: spending?", add_bos=True)
    n_new = 8

    async def run():
        await sched.start()
        try:
            _, t1 = await _collect(sched, "t1", p1, n_new, conversation_id="c")
            snap1 = tuple(a.clone() if a is not None else None
                          for a in sched.session_cache.get("c").snap)
            off1 = METRICS.get("finchat_session_cache_offloaded_pages_total")
            p2 = p1 + t1 + tok.encode(" q2: more?", add_bos=False)
            _, t2 = await _collect(sched, "t2", p2, n_new, conversation_id="c")
            off2 = METRICS.get("finchat_session_cache_offloaded_pages_total")
            return snap1, p2, t2, int(off2 - off1)
        finally:
            await sched.stop()

    snap1, p2, t2, delta = asyncio.run(run())
    matched2 = ((len(p1) + n_new - 1) // PAGE) * PAGE  # resumed at turn 2
    n_tok2 = ((len(p2) + n_new - 1) // PAGE) * PAGE  # turn 2's KV coverage
    assert delta == (n_tok2 - matched2) // PAGE  # only the new pages copied
    assert delta < n_tok2 // PAGE
    # the spliced snapshot leads with turn 1's bytes, unchanged
    snap2 = sched.session_cache.get("c").snap
    assert torch.equal(snap2[0][:, : snap1[0].shape[1]], snap1[0])
    assert snap2[0].shape[1] == n_tok2 // PAGE
    # and it still resumes like a cold run (turn 3)
    p3 = p2 + t2 + tok.encode(" q3: final?", add_bos=False)
    (_, t3_warm), = _run_turns(sched, [p3], "c")
    (_, t3_cold), = _run_turns(_port(models, eos_id=-1, session_bytes=0), [p3], "c")
    assert t3_warm == t3_cold


def test_cancel_and_error_do_not_offload(models):
    tok = ByteTokenizer()
    sched = _port(models)
    p = tok.encode(HEAD + " q: cancel me", add_bos=True)

    async def run():
        await sched.start()
        try:
            handle = await sched.submit("s", p, SamplingParams(temperature=0.0,
                                                               max_new_tokens=48),
                                        conversation_id="c")
            await asyncio.wait_for(handle.events.get(), timeout=120)  # first token
            sched.cancel(handle)
            while True:
                event = await asyncio.wait_for(handle.events.get(), timeout=120)
                if event["type"] == "done":
                    return event
        finally:
            await sched.stop()

    event = asyncio.run(run())
    assert event["reason"] == "cancelled"
    assert len(sched.session_cache) == 0  # no partial-stream snapshots
    sched.allocator.check_invariants()
    assert sched.allocator.used_count == 0


def test_session_resume_matches_jax(models):
    """Two turns of one conversation over a registered head, through the
    JAX and the port schedulers: the same shared and resumed lengths, page
    lists, entry accounting and offloaded pages, and greedy tokens under
    the teacher-forced contract."""
    tok = ByteTokenizer()
    head = tok.encode(HEAD, add_bos=True)
    p1 = head + tok.encode(" q1: how much did I spend on rent?", add_bos=False)

    def run(sched, jax_side):
        shared = sched.register_prefix(head)

        async def go():
            await sched.start()
            try:
                h1, t1 = await _collect(sched, "t1", p1, 10, "conv", jax_side)
                p2 = p1 + t1 + tok.encode(" q2: and food?", add_bos=False)
                h2, t2 = await _collect(sched, "t2", p2, 10, "conv", jax_side)
                return h1, t1, p2, h2, t2
            finally:
                await sched.stop()

        return shared, asyncio.run(go())

    off0 = METRICS.get("finchat_session_cache_offloaded_pages_total")
    js = _jax(models)
    shared_j, (hj1, tj1, pj2, hj2, tj2) = run(js, True)
    ts = _port(models)
    shared_t, (ht1, tt1, pt2, ht2, tt2) = run(ts, False)
    assert shared_t == shared_j > 0
    _assert_teacher_forced(models, p1, tt1, tj1)
    assert tt1 == tj1  # no near tie on turn 1 here, so turn 2 is one prompt
    assert pt2 == pj2
    assert ht1.shared_len == hj1.shared_len == shared_t and ht1.page_list == hj1.page_list
    assert ht2.shared_len == hj2.shared_len == shared_t
    assert ht2.resumed_len == hj2.resumed_len > shared_t
    assert ht2.page_list == hj2.page_list
    _assert_teacher_forced(models, pt2, tt2, tj2)
    ej, et = js.session_cache.get("conv"), ts.session_cache.get("conv")
    assert np.array_equal(et.token_ids, ej.token_ids)
    assert et.prefix_len == ej.prefix_len == shared_t
    assert et.snap[0].shape == tuple(ej.snap[0].shape)
    assert ts.session_cache.resident_bytes == js.session_cache.resident_bytes
    assert METRICS.get("finchat_session_cache_offloaded_pages_total") - off0 == (
        (len(p1) + len(tt1) - 1) // PAGE - shared_t // PAGE
        + ((len(pt2) + len(tt2) - 1) // PAGE * PAGE - ht2.resumed_len) // PAGE)
    assert ts.allocator.used_count == js.allocator.used_count == shared_t // PAGE
    # the port's snapshot holds the KV the JAX one holds (fp32, atol 2e-4)
    for a, b in zip(et.snap[:2], ej.snap[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=0)


# --- page snapshots ----------------------------------------------------------

def _jax_pool(kv_quant: str, rng: np.random.Generator, L=2, P=12, PS=8, n_kv=2, hd=16):
    """A JAX page pool filled with seeded values (bf16, or int8 with scale
    planes), as ``kv_cache.create`` lays it out."""
    shape = (L, P, PS, n_kv * hd)
    if kv_quant:
        k = jnp.asarray(rng.integers(-127, 128, shape, dtype=np.int8))
        v = jnp.asarray(rng.integers(-127, 128, shape, dtype=np.int8))
        sshape = (L, P, 8, PS)
        ks = jnp.asarray(rng.random(sshape, dtype=np.float32))
        vs = jnp.asarray(rng.random(sshape, dtype=np.float32))
        return k, v, ks, vs
    k = jnp.asarray(rng.standard_normal(shape, dtype=np.float32), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal(shape, dtype=np.float32), jnp.bfloat16)
    return k, v, None, None


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_jax_snapshot_roundtrips_through_the_port_pool(kv_quant):
    """A JAX ``gather_pages_host`` snapshot scattered into the port's pool
    and gathered back is bit-identical, scale planes included."""
    rng = np.random.default_rng(3)
    jk, jv, jks, jvs = _jax_pool(kv_quant, rng)
    src = [3, 7, 2]
    snap_j = jkv.gather_pages_host(jk, jv, jks, jvs, src)
    cfg = tllama.LlamaConfig(n_layers=2, n_heads=4, n_kv_heads=2, dim=64)
    pool = tkv.PagedKVCache.create(cfg, 12, 8, "cpu", kv_quant=kv_quant)
    dst = [9, 4, 11]
    snap = _to_torch(snap_j)
    assert snap[0].dtype == (torch.int8 if kv_quant else torch.bfloat16)
    tkv.scatter_pages_device(pool.k_pages, pool.v_pages, pool.k_scales, pool.v_scales, dst, snap)
    back = tkv.gather_pages_host(pool.k_pages, pool.v_pages, pool.k_scales, pool.v_scales, dst)
    assert snap_kv_mode(back) == kv_quant
    for got, want in zip(back, snap_j):
        assert _raw(got) == _np_raw(want)
    # the snapshot owns its bytes: the pool moving on does not touch it
    pool.k_pages.zero_()
    assert _raw(back[0]) == _np_raw(snap_j[0])


def test_scatter_pages_cross_mode_raises():
    """The last line behind the counted refusals: a snapshot of the other
    page-pool dtype raises instead of casting into garbage KV."""
    cfg = tllama.LlamaConfig(n_layers=2, n_heads=4, n_kv_heads=2, dim=64)
    bf = tkv.PagedKVCache.create(cfg, 8, 8, "cpu")
    q8 = tkv.PagedKVCache.create(cfg, 8, 8, "cpu", kv_quant="int8")
    snap_q8 = tkv.gather_pages_host(q8.k_pages, q8.v_pages, q8.k_scales, q8.v_scales, [1, 2])
    with pytest.raises(ValueError, match="cross-mode"):
        tkv.scatter_pages_device(bf.k_pages, bf.v_pages, None, None, [3, 4], snap_q8)
    snap_bf = tkv.gather_pages_host(bf.k_pages, bf.v_pages, None, None, [1])
    with pytest.raises(ValueError, match="cross-mode"):
        tkv.scatter_pages_device(q8.k_pages, q8.v_pages, q8.k_scales, q8.v_scales, [3], snap_bf)


def test_int8_engine_offload_restore_byte_identity_ram_and_disk(models, tmp_path):
    """An int8-KV engine's snapshot (data ints and scale planes) survives
    offload -> disk record -> restore byte for byte, and matches the JAX
    engine's snapshot of the same prefill (ints within one step, scales
    within fp32 noise: the K/V rows come from fp32 matmuls ~1e-4 apart)."""
    jcfg, jparams, tcfg, tparams = models
    cfg = dict(max_seqs=4, page_size=8, num_pages=64, max_seq_len=128, prefill_chunk=8,
               kv_quant="int8", preemption=False, breaker_threshold=0)
    eng = InferenceEngine(tcfg, tparams, EngineConfig(**cfg), device="cpu")
    pages = PageAllocator(64).allocate("s", 4)
    eng.set_page_table_row(0, pages)
    eng.prefill(0, list(range(1, 25)))  # 3 pages of real KV
    snap = eng.offload_pages(pages[:3])
    assert snap[2] is not None and snap[3] is not None and snap_kv_mode(snap) == "int8"
    tier = SessionDiskTier(str(tmp_path), 1 << 20, kv_quant="int8")
    assert tier.spill("conv", np.arange(24, dtype=np.int32), 0, snap)
    payload = tier.load("conv")  # barriers on the queued write
    tier.close()
    for a, b in zip(payload["snap"], snap):
        assert _raw(a) == _raw(b)
    eng2 = InferenceEngine(tcfg, tparams, EngineConfig(**cfg), device="cpu")
    fresh = [9, 10, 11]
    eng2.restore_pages(fresh, payload["snap"])
    for a, b in zip(eng2.offload_pages(fresh), snap):
        assert _raw(a) == _raw(b)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**cfg), attn_backend="ref")
    jeng.set_page_table_row(0, pages)
    jeng.prefill(0, list(range(1, 25)))
    jsnap = jeng.offload_pages(pages[:3])
    assert np.abs(snap[0].numpy().astype(np.int32) - jsnap[0].astype(np.int32)).max() <= 1
    np.testing.assert_allclose(snap[2].numpy(), jsnap[2], rtol=1e-3, atol=1e-6)


# --- the disk tier -------------------------------------------------------------

def _f32_snap(*shape, fill=None):
    a = (torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape) if fill is None
         else torch.full(shape, fill, dtype=torch.float32))
    return (a, a.clone() + 0.5, None, None)


def test_disk_record_roundtrip_byte_identity(tmp_path):
    tier = SessionDiskTier(str(tmp_path), 1 << 20)
    tok = np.arange(24, dtype=np.int32)
    snap = _f32_snap(2, 3, 16)
    assert tier.spill("c1#resp", tok, 8, snap)
    payload = tier.load("c1#resp")
    assert np.array_equal(payload["token_ids"], tok) and payload["token_ids"].dtype == np.int32
    assert payload["prefix_len"] == 8
    assert _raw(payload["snap"][0]) == _raw(snap[0])
    assert _raw(payload["snap"][1]) == _raw(snap[1])
    assert payload["snap"][2] is None and payload["snap"][3] is None
    # a None snap (a prefix-only entry) round-trips too
    assert tier.spill("c2#resp", tok[:8], 8, None)
    p2 = tier.load("c2#resp")
    assert p2["snap"] is None and np.array_equal(p2["token_ids"], tok[:8])
    tier.close()


def test_bf16_snapshot_dtype_roundtrips(tmp_path):
    snap = (torch.arange(64, dtype=torch.float32).to(torch.bfloat16).reshape(2, 2, 16),
            torch.ones((2, 2, 16), dtype=torch.bfloat16), None, None)
    tier = SessionDiskTier(str(tmp_path), 1 << 20)
    assert tier.spill("c", np.arange(8, dtype=np.int32), 0, snap)
    p = tier.load("c")  # barriers on the queued write
    tier.close()
    assert p is not None and p["snap"][0].dtype == torch.bfloat16
    assert torch.equal(p["snap"][0], snap[0])
    header, _off = SessionDiskTier._read_header((tmp_path / SessionDiskTier._fname("c"))
                                                .read_bytes())
    assert header["snap"][0] == {"dtype": "bfloat16", "shape": [2, 2, 16]}


def test_v1_record_still_readable(tmp_path):
    snap = _f32_snap(2, 1, 4, fill=1.0)
    blob = SessionDiskTier._serialize("c3", np.arange(4, dtype=np.int32), 0, snap)
    hlen = int.from_bytes(blob[5:9], "big")
    hdr = json.loads(blob[9 : 9 + hlen])
    payload = blob[9 + hlen:]
    hdr.pop("kv")  # version 1 had no mode stamp
    for s in hdr["snap"]:
        if s:
            s["dtype"] = np.dtype(s["dtype"]).str  # version 1 stored dtype.str
    h2 = json.dumps(hdr).encode()
    v1 = SessionDiskTier.MAGIC + bytes([1]) + len(h2).to_bytes(4, "big") + h2 + payload
    (tmp_path / SessionDiskTier._fname("c3")).write_bytes(v1)
    tier = SessionDiskTier(str(tmp_path), 1 << 20)
    p = tier.load("c3")
    tier.close()
    assert p is not None and p["snap"][0].dtype == torch.float32
    assert torch.equal(p["snap"][0], snap[0])


def test_disk_tier_lru_budget(tmp_path):
    tier = SessionDiskTier(str(tmp_path), budget_bytes=1 << 20)
    snap = _f32_snap(2, 4, 64, fill=0.0)  # ~4 KiB a record
    record_size = len(SessionDiskTier._serialize("k", np.arange(8, dtype=np.int32), 0, snap))
    tier.budget_bytes = int(2.5 * record_size)
    for i in range(4):
        assert tier.spill(f"conv{i}", np.arange(8, dtype=np.int32), 0, snap)
    tier.flush()  # write-behind: evictions land on the writer thread
    assert len(tier) == 2  # ~2.5 records fit: the two oldest went
    assert tier.resident_bytes <= tier.budget_bytes
    assert "conv0" not in tier and "conv1" not in tier
    assert tier.load("conv3") is not None
    # a loaded (refreshed) record survives the next spill's eviction
    tier.load("conv2")
    tier.spill("conv4", np.arange(8, dtype=np.int32), 0, snap)
    tier.flush()
    assert "conv2" in tier
    tier.close()


def test_disk_tier_startup_sweep_orphans_and_corruption(tmp_path):
    tier = SessionDiskTier(str(tmp_path), 1 << 20)
    snap = _f32_snap(2, 2, 8, fill=1.0)
    tier.spill("good", np.arange(16, dtype=np.int32), 0, snap)
    tier.spill("truncated", np.arange(16, dtype=np.int32), 0, snap)
    tier.flush()
    tier.close()
    # crash leftovers: a partial .tmp write and a truncated record
    (tmp_path / "deadbeef.skv.tmp").write_bytes(b"partial")
    trunc = tmp_path / SessionDiskTier._fname("truncated")
    trunc.write_bytes(trunc.read_bytes()[:-7])
    q0 = METRICS.get("finchat_durability_quarantines_total")
    swept = SessionDiskTier(str(tmp_path), 1 << 20)
    assert "good" in swept and len(swept) == 1
    assert not list(tmp_path.glob("*.tmp"))
    assert list(tmp_path.glob("*.quarantine"))
    assert METRICS.get("finchat_durability_quarantines_total") == q0 + 1
    assert swept.load("good") is not None
    assert swept.load("truncated") is None
    swept.close()


def test_queued_spill_is_visible_before_it_lands(tmp_path):
    """Membership sees QUEUED writes, and ``load`` barriers on a queued
    write (or discard) of its own key."""
    tier = SessionDiskTier(str(tmp_path), 1 << 20)
    gate = threading.Event()
    tier._writer.submit(gate.wait)  # wedge the writer: writes stay queued
    snap = _f32_snap(2, 2, 8, fill=1.0)
    try:
        tier.spill("convQ", np.arange(16, dtype=np.int32), 0, snap)
        assert "convQ" in tier  # queued, not landed
        assert len(tier) == 0  # the index holds landed records only
        assert not list(tmp_path.glob("*.skv"))
    finally:
        gate.set()
    payload = tier.load("convQ")  # barriers on the pending write
    assert payload is not None and "convQ" in tier and len(tier) == 1
    wedge = threading.Event()
    tier._writer.submit(wedge.wait)
    tier.discard("convQ")
    wedge.set()
    assert tier.load("convQ") is None
    assert "convQ" not in tier
    tier.close()


@pytest.mark.parametrize("direction", ["q8_into_bf16", "bf16_into_q8"])
def test_cross_mode_record_refused_and_counted(tmp_path, direction):
    """A valid record written under the other page-pool dtype is set aside
    (``*.crossmode``, not a quarantine), counted as a dequant fallback, and
    the conversation starts cold; the startup sweep applies the same rule."""
    if direction == "q8_into_bf16":
        snap = (torch.ones((2, 1, 8, 16), dtype=torch.int8),
                torch.ones((2, 1, 8, 16), dtype=torch.int8),
                torch.ones((2, 1, 8, 8)), torch.ones((2, 1, 8, 8)))
        writer_mode, reader_mode = "int8", ""
    else:
        snap = (torch.ones((2, 1, 8, 16)), torch.ones((2, 1, 8, 16)), None, None)
        writer_mode, reader_mode = "", "int8"
    writer = SessionDiskTier(str(tmp_path), 1 << 20, kv_quant=writer_mode)
    assert writer.spill("conv", np.arange(8, dtype=np.int32), 0, snap)
    writer.close()  # the queued write lands
    before = METRICS.get("finchat_quant_dequant_fallbacks_total")
    q_before = METRICS.get("finchat_durability_quarantines_total")
    reader = SessionDiskTier(str(tmp_path), 1 << 20, kv_quant=reader_mode)
    assert "conv" not in reader  # the sweep set it aside
    assert reader.load("conv") is None
    assert METRICS.get("finchat_quant_dequant_fallbacks_total") == before + 1
    assert METRICS.get("finchat_durability_quarantines_total") == q_before
    assert list(tmp_path.glob("*.crossmode"))
    reader.close()


def test_prefix_only_records_are_mode_agnostic(tmp_path):
    writer = SessionDiskTier(str(tmp_path), 1 << 20, kv_quant="int8")
    assert writer.spill("conv", np.arange(16, dtype=np.int32), 16, None)
    writer.close()  # the queued write lands
    reader = SessionDiskTier(str(tmp_path), 1 << 20, kv_quant="")
    p = reader.load("conv")
    assert p is not None and p["snap"] is None and p["prefix_len"] == 16
    reader.close()


def test_closed_tier_writes_inline(tmp_path):
    """Once closed, a tier has no writer thread: a spill lands before it
    returns, and a discard likewise."""
    tier = SessionDiskTier(str(tmp_path), 1 << 20)
    tier.close()
    assert tier.spill("conv", np.arange(8, dtype=np.int32), 0, _f32_snap(2, 1, 8))
    assert "conv" in tier and len(tier) == 1
    assert (tmp_path / SessionDiskTier._fname("conv")).exists()
    tier.discard("conv")
    assert "conv" not in tier and not list(tmp_path.glob("*.skv"))


def test_import_session_entry_cross_mode_refused_and_counted(models):
    sched = _port(models)  # a float32 pool
    snap_q8 = (torch.zeros((2, 1, 8, 16), dtype=torch.int8),
               torch.zeros((2, 1, 8, 16), dtype=torch.int8),
               torch.ones((2, 1, 8, 8)), torch.ones((2, 1, 8, 8)))
    payload = {"conversation_id": "x", "token_ids": np.arange(8, dtype=np.int32),
               "prefix_len": 0, "snap": snap_q8}
    before = METRICS.get("finchat_quant_dequant_fallbacks_total")
    assert not sched.import_session_entry(payload)
    assert METRICS.get("finchat_quant_dequant_fallbacks_total") == before + 1
    assert sched.session_cache.get("x") is None


@pytest.mark.parametrize("snap", [None, "own"])
def test_import_session_entry_refuses_bounded_kv_entry(models, snap):
    """A bounded-KV entry (``kv_gap`` > 0, the JAX package's windowed plane)
    is refused and counted; nothing is held and no page is taken."""
    sched = _port(models)
    own = _f32_snap(2, 1, PAGE, 16) if snap else None
    payload = {"conversation_id": "g", "token_ids": np.arange(16, dtype=np.int32),
               "prefix_len": 0, "snap": own, "kv_gap": PAGE, "kv_sink": PAGE}
    before = METRICS.get("finchat_fleet_session_import_refused_total")
    assert not sched.import_session_entry(payload)
    assert METRICS.get("finchat_fleet_session_import_refused_total") == before + 1
    assert sched.session_cache.get("g") is None and len(sched.session_cache) == 0
    assert sched.allocator.used_count == 0


def _records(kv_quant: str):
    """The same snapshot as each package holds it: (JAX numpy, port torch)."""
    rng = np.random.default_rng(11)
    jk, jv, jks, jvs = _jax_pool(kv_quant, rng)
    snap_j = jkv.gather_pages_host(jk, jv, jks, jvs, [1, 5])
    return snap_j, _to_torch(snap_j)


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_records_are_byte_identical_across_packages(kv_quant):
    snap_j, snap_t = _records(kv_quant)
    tok = np.arange(40, dtype=np.int32)
    blob_j = JaxDiskTier._serialize("conv#resp", tok, 24, snap_j)
    blob_t = SessionDiskTier._serialize("conv#resp", tok, 24, snap_t)
    assert blob_t == blob_j
    assert SessionDiskTier._serialize("c", tok[:8], 8, None) == JaxDiskTier._serialize(
        "c", tok[:8], 8, None)


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_each_package_reads_the_others_records(tmp_path, kv_quant):
    snap_j, snap_t = _records(kv_quant)
    tok = np.arange(40, dtype=np.int32)
    j_dir, t_dir = tmp_path / "jax", tmp_path / "port"
    jt = JaxDiskTier(str(j_dir), 1 << 22, async_writes=False, kv_quant=kv_quant)
    assert jt.spill("conv", tok, 24, snap_j)
    tt = SessionDiskTier(str(t_dir), 1 << 22, kv_quant=kv_quant)
    assert tt.spill("conv", tok, 24, snap_t)
    tt.close()  # the queued write lands
    # the port reads the JAX package's record...
    reader = SessionDiskTier(str(j_dir), 1 << 22, kv_quant=kv_quant)
    from_jax = reader.load("conv")
    reader.close()
    assert from_jax["prefix_len"] == 24 and np.array_equal(from_jax["token_ids"], tok)
    for got, want in zip(from_jax["snap"], snap_j):
        assert _raw(got) == _np_raw(want)
    # ...and the JAX package the port's
    from_port = JaxDiskTier(str(t_dir), 1 << 22, async_writes=False,
                            kv_quant=kv_quant).load("conv")
    assert from_port["prefix_len"] == 24 and np.array_equal(from_port["token_ids"], tok)
    for i, (got, want) in enumerate(zip(from_port["snap"], snap_t)):
        assert _np_raw(got) == _raw(want)
        if got is not None:
            assert got.dtype == (np.float32 if i >= 2 else
                                 np.int8 if kv_quant else ml_dtypes.bfloat16)


# --- restarts and faults over the disk tier ---------------------------------------

def _disk(models, path, **kw):
    return _port(models, eos_id=-1, disk_path=path, **kw)


def test_spill_restore_byte_identity_vs_ram_tier(models, tmp_path):
    """A restarted scheduler (fresh RAM tier, same directory) resumes a
    conversation exactly as deep as the RAM tier would have, with the same
    greedy tokens."""
    t1 = list(range(1, 14))

    async def run():
        sched = _disk(models, tmp_path / "disk")
        await sched.start()
        _, toks1 = await _collect(sched, "a-t1", t1, 8, conversation_id="convA")
        t2 = t1 + toks1 + [7, 8, 9]
        h_ram, toks2_ram = await _collect(sched, "a-t2", t2, 8, conversation_id="convA")
        await sched.stop()
        sched.session_cache.disk.flush()
        sched2 = _disk(models, tmp_path / "disk")  # "crash": the RAM tier is gone
        assert sched2.session_cache.get("convA") is None
        restores0 = METRICS.get("finchat_durability_disk_restores_total")
        await sched2.start()
        h_disk, toks2_disk = await _collect(sched2, "b-t2", t2, 8, conversation_id="convA")
        await sched2.stop()
        assert METRICS.get("finchat_durability_disk_restores_total") == restores0 + 1
        assert h_disk.resumed_len == h_ram.resumed_len > 0
        assert toks2_disk == toks2_ram  # the same restored bytes, the same steps
        sched2.allocator.check_invariants()

    asyncio.run(run())


def test_corrupt_record_quarantined_cold_start(models, tmp_path):
    t1 = list(range(1, 14))

    async def run():
        sched = _disk(models, tmp_path / "disk")
        await sched.start()
        _, toks1 = await _collect(sched, "a-t1", t1, 8, conversation_id="convB")
        await sched.stop()
        sched.session_cache.disk.flush()
        t2 = t1 + toks1 + [7, 8, 9]
        f = (tmp_path / "disk") / SessionDiskTier._fname("convB")
        raw = bytearray(f.read_bytes())
        raw[-1] ^= 0xFF
        f.write_bytes(bytes(raw))
        q0 = METRICS.get("finchat_durability_quarantines_total")
        sched2 = _disk(models, tmp_path / "disk")
        await sched2.start()
        h, toks2 = await _collect(sched2, "b-t2", t2, 8, conversation_id="convB")
        await sched2.stop()
        assert h.resumed_len == 0  # cold, not stale KV
        assert METRICS.get("finchat_durability_quarantines_total") == q0 + 1
        assert list((tmp_path / "disk").glob("*.quarantine"))
        sched3 = _port(models, eos_id=-1)
        await sched3.start()
        _, toks_cold = await _collect(sched3, "c-t2", t2, 8)
        await sched3.stop()
        assert toks2 == toks_cold  # both cold: the same prefill, the same tokens

    asyncio.run(run())


def test_bounded_kv_record_on_disk_starts_cold(models, tmp_path):
    """A record the JAX package wrote under bounded KV (``kv_gap`` > 0) is
    read, refused at import (counted) and the turn starts cold."""
    t1 = list(range(1, 14))

    async def run():
        sched = _disk(models, tmp_path / "disk")
        await sched.start()
        _, toks1 = await _collect(sched, "a-t1", t1, 8, conversation_id="convG")
        await sched.stop()
        sched.session_cache.disk.close()
        f = (tmp_path / "disk") / SessionDiskTier._fname("convG")
        rec = SessionDiskTier._deserialize(f.read_bytes())
        snap = tuple(None if a is None else a.numpy() for a in rec["snap"])
        f.write_bytes(JaxDiskTier._serialize("convG", rec["token_ids"], rec["prefix_len"],
                                             snap, kv_gap=PAGE, kv_sink=PAGE))
        t2 = t1 + toks1 + [7, 8, 9]
        refused0 = METRICS.get("finchat_fleet_session_import_refused_total")
        sched2 = _disk(models, tmp_path / "disk")
        assert "convG" in sched2.session_cache.disk  # a valid record, not quarantined
        await sched2.start()
        h, toks2 = await _collect(sched2, "b-t2", t2, 8, conversation_id="convG")
        await sched2.stop()
        assert h.resumed_len == 0 and h.prefill_pos == len(t2)
        assert METRICS.get("finchat_fleet_session_import_refused_total") == refused0 + 1
        sched2.allocator.check_invariants()
        assert sched2.allocator.used_count == 0
        sched3 = _port(models, eos_id=-1)
        await sched3.start()
        _, toks_cold = await _collect(sched3, "c-t2", t2, 8)
        await sched3.stop()
        assert toks2 == toks_cold

    asyncio.run(run())


def test_over_budget_record_trims_to_partial_warm_resume(models, tmp_path):
    t1 = list(range(1, 14))

    async def run():
        sched = _disk(models, tmp_path / "disk")
        await sched.start()
        _, toks1 = await _collect(sched, "a-t1", t1, 8, conversation_id="convO")
        await sched.stop()
        sched.session_cache.disk.flush()
        entry = sched.session_cache.get("convO")
        own_pages = (entry.n_tokens - entry.prefix_len) // PAGE
        assert own_pages >= 2
        per_page = entry.nbytes // own_pages
        t2 = t1 + toks1 + [7, 8, 9]
        # restart with a RAM budget that holds one of the record's pages
        sched2 = _disk(models, tmp_path / "disk", session_bytes=per_page + per_page // 2)
        await sched2.start()
        h, toks2 = await _collect(sched2, "b-t2", t2, 8, conversation_id="convO")
        await sched2.stop()
        assert 0 < h.resumed_len <= PAGE  # trimmed: warm, just shallower
        sched3 = _port(models, eos_id=-1)
        await sched3.start()
        _, toks_cold = await _collect(sched3, "c-t2", t2, 8)
        await sched3.stop()
        assert toks2 == toks_cold
        sched2.allocator.check_invariants()

    asyncio.run(run())


def test_restore_skips_redundant_respill(models, tmp_path):
    t1 = list(range(1, 14))

    async def run():
        sched = _disk(models, tmp_path / "disk")
        await sched.start()
        await _collect(sched, "a-t1", t1, 8, conversation_id="convP")
        await sched.stop()
        sched.session_cache.disk.flush()
        sched2 = _disk(models, tmp_path / "disk")
        s0 = METRICS.get("finchat_durability_spills_total")
        assert sched2._restore_session_from_disk("convP")
        sched2.session_cache.disk.flush()
        assert METRICS.get("finchat_durability_spills_total") == s0
        assert sched2.session_cache.get("convP") is not None

    asyncio.run(run())


def test_disk_spill_failure_never_fails_stream(models, tmp_path):
    sched = _disk(models, tmp_path / "disk")
    tier = sched.session_cache.disk
    calls = {"n": 0}

    def failing_serialize(*a, **k):  # one failed write, as a full disk gives
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk full")
        return SessionDiskTier._serialize(*a, **k)

    tier._serialize = failing_serialize
    f0 = METRICS.get("finchat_durability_spill_failures_total")

    async def run():
        await sched.start()
        h, toks = await _collect(sched, "s1", list(range(1, 14)), 8, conversation_id="convF")
        await sched.stop()
        return toks

    toks = asyncio.run(run())
    tier.flush()  # the failure lands on the writer thread
    assert len(toks) == 8  # the stream retired normally
    assert METRICS.get("finchat_durability_spill_failures_total") == f0 + 1
    assert "convF" not in tier and not list((tmp_path / "disk").glob("*.tmp"))
    assert sched.session_cache.get("convF") is not None  # the RAM entry stays


def test_disk_restore_failure_quarantines_and_cold_starts(models, tmp_path):
    t1 = list(range(1, 14))

    async def run():
        sched = _disk(models, tmp_path / "disk")
        await sched.start()
        _, toks1 = await _collect(sched, "a-t1", t1, 8, conversation_id="convR")
        await sched.stop()
        sched.session_cache.disk.flush()
        sched2 = _disk(models, tmp_path / "disk")
        tier = sched2.session_cache.disk
        assert "convR" in tier

        def failing_read(raw):
            raise OSError("read error")

        tier._deserialize = failing_read
        q0 = METRICS.get("finchat_durability_quarantines_total")
        await sched2.start()
        h, toks2 = await _collect(sched2, "b-t2", t1 + toks1 + [7, 8, 9], 8,
                                  conversation_id="convR")
        await sched2.stop()
        assert len(toks2) == 8 and h.resumed_len == 0  # cold, never stale
        assert METRICS.get("finchat_durability_quarantines_total") == q0 + 1
        assert list((tmp_path / "disk").glob("*.quarantine"))

    asyncio.run(run())


def test_spill_sessions_makes_every_entry_durable(models, tmp_path):
    """``spill_sessions`` rewrites every resident entry and waits for the
    writes: a fresh scheduler on the directory finds each conversation."""
    sched = _disk(models, tmp_path / "disk")

    async def run():
        await sched.start()
        for c in ("a", "b"):
            await _collect(sched, c, list(range(1, 20)), 6, conversation_id=c)
        await sched.stop()

    asyncio.run(run())
    assert sched.spill_sessions() == 2
    again = _disk(models, tmp_path / "disk")
    assert "a" in again.session_cache.disk and "b" in again.session_cache.disk
    assert again.export_session("a") is None  # RAM is empty until a restore
    assert again._restore_session_from_disk("a")
    exported = again.export_session("a")
    original = sched.export_session("a")
    assert np.array_equal(exported["token_ids"], original["token_ids"])
    for got, want in zip(exported["snap"], original["snap"]):
        assert (got is None and want is None) or torch.equal(got, want)
