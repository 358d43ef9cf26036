"""The rank side of tests/test_torch_sequence_parallel.py and
tests/test_torch_ring_serving.py: what each spawned gloo rank runs. It
imports only torch and the port (a spawned rank never imports JAX) and
hands its results back by value (``torch_train_ranks.World`` spawns the
world: a fresh ``file://`` rendezvous, a 60 s collective timeout, every join
and queue read bounded).

Every rank of the world runs every case in order; a case names the world
ranks its mesh spans (every rank makes every group, the ranks outside the
mesh skip the case). Kinds:

- ``ops``: ``ops/ring_attention`` and ``ops/ulysses`` on this rank's block
  of seeded ``q``, ``k``, ``v`` (and a cached prefix), each listed call's
  output block, with the collectives it issued;
- ``engine``: an engine over the mesh, rank 0 driving (``parallel/ranks.
  Leader``) and the others following: its warmup (when asked), then greedy
  turns prefilled by the routed ``prefill`` or by segments
  (``prefill_ring_segment``), each turn's tokens, logits and session
  record; every rank's own pool;
- ``scheduler``: the port's scheduler on rank 0 over such an engine, one
  named scenario (``SCENARIOS``), the others following.
"""

from __future__ import annotations

import asyncio
import datetime
import io
import traceback

import numpy as np
import torch

from finchat_tpu_torch.engine.engine import InferenceEngine
from finchat_tpu_torch.engine.kv_cache import PageAllocator, pages_needed
from finchat_tpu_torch.engine.sampler import SamplingParams
from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from finchat_tpu_torch.ops import ring_attention, ulysses
from finchat_tpu_torch.parallel import collectives
from finchat_tpu_torch.parallel.mesh import AXES, MeshSpec, build_mesh, initialize_distributed
from finchat_tpu_torch.parallel.ranks import Leader, RankChannel, follow
from finchat_tpu_torch.utils.metrics import METRICS

TIMEOUT_S = 60.0


def _block(a: np.ndarray, n: int, idx: int) -> torch.Tensor:
    """Block ``idx`` of ``n`` of ``a`` along the sequence (dim 1)."""
    S = a.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(a[:, idx * S:(idx + 1) * S]))


def ops_case(mesh, case: dict) -> dict:
    n, idx = mesh.shape["seq"], mesh.coords["seq"]
    q, k, v = (_block(case[x], n, idx) for x in ("q", "k", "v"))
    out: dict = {"coords": mesh.coords}
    for name, (op, causal) in case["calls"].items():
        collectives.reset_collectives()
        kw = dict(mesh=mesh, causal=causal)
        if op == "ring":
            got = ring_attention.ring_attention(q, k, v, **kw)
        elif op == "ulysses":
            got = ulysses.ulysses_attention(q, k, v, **kw)
        else:
            fn = (ring_attention.ring_attention_with_prefix if op == "ring_prefix"
                  else ulysses.ulysses_attention_with_prefix)
            got = fn(q, k, v, torch.from_numpy(case["kp"]), torch.from_numpy(case["vp"]),
                     case["prefix_len"], **kw)
        out[name] = got
        out[name + "_collectives"] = {k: c for k, c in collectives.COLLECTIVES.items() if c}
    return out


def _engine(mesh, case: dict) -> InferenceEngine:
    return InferenceEngine(case["config"], case["params"], case["ecfg"], device="cpu",
                           quant=case.get("quant", ""), mesh=mesh)


def turn(engine, prompt: list[int], n_new: int, how: str, slot: int = 0) -> dict:
    """A greedy turn at the engine's seams: its pages, the prompt prefilled
    (``prefill``: routed by length; ``segments``: ``prefill_ring_segment``
    from position 0 a segment at a time), the first token, ``n_new - 1``
    decode steps. The tokens, the fp32 logits of every step, the turn's
    pages and their record."""
    alloc = PageAllocator(engine.engine_cfg.num_pages)
    pages = alloc.allocate("s", pages_needed(len(prompt) + n_new, engine.page_size))
    engine.set_page_table_row(slot, pages)
    collectives.reset_collectives()
    if how == "segments":
        rc = engine.ring_segment_tokens()
        for start in range(0, len(prompt), rc):
            logits = engine.prefill_ring_segment(slot, list(prompt[start:start + rc]), start)
    else:
        logits = engine.prefill(slot, list(prompt))
    used = {k: c for k, c in collectives.COLLECTIVES.items() if c}
    context = int(engine.state.context_lens[slot])
    tok = engine.commit_first_token(slot, logits, 0.0, 1.0, 0)
    tokens, rows = [int(tok)], [logits.clone()]
    B = engine.engine_cfg.max_seqs
    active = np.zeros(B, bool)
    active[slot] = True
    z, o, zk = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    for _ in range(n_new - 1):
        t, lg = engine.decode(active, z, o, zk, return_logits=True)
        tokens.append(int(t[slot]))
        rows.append(lg[slot].clone())
    return dict(tokens=tokens, logits=torch.stack(rows), pages=pages, context=context,
                collectives=used, record=engine.offload_pages(pages))


def engine_case(mesh, channel, case: dict) -> dict:
    engine = _engine(mesh, case)
    out: dict = {"coords": mesh.coords, "sp_mode": engine.sp_mode,
                 "buckets": {n: engine._ring_bucket(n) for n in (16, 33, 50, 100)},
                 "prefix_pages": {p: engine._prefix_page_bucket(p) for p in (1, 32, 64, 96, 200)}}
    if mesh.rank == 0:
        leader = Leader(engine, channel)
        try:
            if case.get("warmup"):
                engine.warmup()
                out["compiled_variants"] = engine.compiled_variants
            for key, args in case["turns"].items():
                out[key] = turn(engine, *args)
                engine.reset_slot(0)
        finally:
            leader.stop()
    else:
        out["calls"] = follow(engine, channel)
    out["local"] = tuple(None if t is None else t.clone() for t in
                         (engine.state.k_pages, engine.state.v_pages, engine.state.k_scales,
                          engine.state.v_scales))
    return out


# --- scheduler scenarios (rank 0) --------------------------------------------------------

async def _tokens(handle) -> list[int]:
    out = []
    while True:
        event = await asyncio.wait_for(handle.events.get(), timeout=TIMEOUT_S)
        if event["type"] == "done":
            return out
        assert event["type"] == "token", event
        out.append(event["token_id"])


def _greedy(n: int) -> SamplingParams:
    return SamplingParams(temperature=0.0, max_new_tokens=n)


def _spy(engine, name: str, record: list, what=lambda *a: len(a[1])):
    real = getattr(engine, name)

    def spy(*a, **k):
        record.append(what(*a))
        return real(*a, **k)

    setattr(engine, name, spy)


async def scenario_routes(sched, case: dict) -> dict:
    """A long prompt through the scheduler on its own: the ring entries it
    took (the prompt's length a call) and its stream."""
    ring, seg = [], []
    _spy(sched.engine, "prefill_ring", ring)
    _spy(sched.engine, "prefill_ring_segment", seg)
    h = await sched.submit("long", list(case["prompt"]), _greedy(case["n_new"]))
    return dict(tokens=await _tokens(h), ring_calls=ring, segment_calls=seg,
                ring_path=h.ring_path)


async def scenario_progress(sched, case: dict) -> dict:
    """A stream decodes while a long prompt prefills by segments: the
    stream's tokens at each segment's call (so the tokens between them),
    and both streams."""
    seen: list[int] = []
    stream = await sched.submit("stream", list(case["short"]), _greedy(case["short_new"]))
    got = []
    while len(got) < 4:  # steady decode first
        event = await asyncio.wait_for(stream.events.get(), timeout=TIMEOUT_S)
        assert event["type"] == "token", event
        got.append(event["token_id"])
    _spy(sched.engine, "prefill_ring_segment", seen, lambda *a: stream.generated)
    _spy(sched.engine, "prefill_ring", seen, lambda *a: stream.generated)
    long = await sched.submit("long", list(case["prompt"]), _greedy(case["n_new"]))
    rest, tokens = await asyncio.gather(_tokens(stream), _tokens(long))
    return dict(at_calls=seen, tokens=tokens, stream=got + rest)


async def scenario_prefix(sched, case: dict) -> dict:
    """A long prompt over a registered head (when ``register``): the head's
    tokens saved, the ring path taken and the stream."""
    if case["register"]:
        assert sched.register_prefix(list(case["head"])) == len(case["head"])
    seg: list = []
    _spy(sched.engine, "prefill_ring_segment", seg, lambda *a: (len(a[1]), a[2]))
    saved = METRICS.get("finchat_prefix_tokens_saved_total")
    h = await sched.submit("s", list(case["prompt"]), _greedy(case["n_new"]))
    tokens = await _tokens(h)
    return dict(tokens=tokens, ring_path=h.ring_path, segment_calls=seg,
                saved=METRICS.get("finchat_prefix_tokens_saved_total") - saved)


async def scenario_promotion(sched, case: dict) -> dict:
    """A long prompt admitted while a short stream decodes (mixed rounds on):
    both streams, the ring entries taken and the ring demotions."""
    ring: list = []
    _spy(sched.engine, "prefill_ring", ring)
    _spy(sched.engine, "prefill_ring_segment", ring)
    key = 'finchat_mixed_demotions_total{reason="ring"}'
    before = METRICS.snapshot().get(key, 0)
    hs = await sched.submit("short", list(case["short"]), _greedy(case["short_new"]))
    first = await asyncio.wait_for(hs.events.get(), timeout=TIMEOUT_S)
    second = await asyncio.wait_for(hs.events.get(), timeout=TIMEOUT_S)
    hl = await sched.submit("long", list(case["prompt"]), _greedy(case["n_new"]))
    rest, tokens = await asyncio.gather(_tokens(hs), _tokens(hl))
    return dict(stream=[first["token_id"], second["token_id"]] + rest, tokens=tokens,
                ring_calls=ring, ring_demotions=METRICS.snapshot().get(key, 0) - before,
                demotion_seeded=key in METRICS.snapshot())


SCENARIOS = {"routes": scenario_routes, "progress": scenario_progress,
             "prefix": scenario_prefix, "promotion": scenario_promotion}


def scheduler_case(mesh, channel, case: dict) -> dict:
    engine = _engine(mesh, case)
    out: dict = {"coords": mesh.coords}
    if mesh.rank == 0:
        leader = Leader(engine, channel)
        try:
            sched = ContinuousBatchingScheduler(engine, eos_id=-1)

            async def run():
                await sched.start()
                try:
                    return await SCENARIOS[case["scenario"]](sched, case)
                finally:
                    await sched.stop()

            out.update(asyncio.run(run()))
            sched.retire_prefixes()
            out["pages_in_use"] = sched.allocator.used_count
        finally:
            leader.stop()
    else:
        out["calls"] = follow(engine, channel)
    return out


KINDS = {"ops": ops_case, "engine": engine_case, "scheduler": scheduler_case}


def rank_main(rank: int, world: int, init_method: str, cases_path: str, queue) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    results: dict = {}
    try:
        cases = torch.load(cases_path, weights_only=False)
        initialize_distributed(world, rank, backend="gloo", init_method=init_method,
                               timeout_s=TIMEOUT_S)
        try:
            for name, case in cases.items():
                ranks = list(case["ranks"])
                mesh = build_mesh(MeshSpec(**dict(zip(AXES, case["sizes"]))),
                                  ["cpu"] * len(ranks), "gloo", ranks=ranks, timeout_s=TIMEOUT_S)
                group = None
                if case["kind"] != "ops":  # the rank channel's own group, made by every rank
                    group = dist.new_group(ranks, backend="gloo",
                                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
                if mesh is None:
                    continue
                if case["kind"] == "ops":
                    results[name] = ops_case(mesh, case)
                else:
                    channel = RankChannel(mesh, TIMEOUT_S, group=group)
                    results[name] = KINDS[case["kind"]](mesh, channel, case)
        finally:
            dist.destroy_process_group()
    except Exception:  # the process's boundary: the parent reports it
        results = {"error": traceback.format_exc()}
    buf = io.BytesIO()
    torch.save(results, buf)
    queue.put((rank, buf.getvalue()))
