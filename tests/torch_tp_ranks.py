"""The rank side of tests/test_torch_tp_engine.py: what each spawned gloo
rank runs. It imports only torch and the port (a spawned rank never
imports JAX), and hands its results back through a queue.

``run_group(world, cases)`` spawns ``world`` CPU ranks (a fresh ``file://``
rendezvous, a 60 s collective timeout, every join and queue read bounded)
and returns ``{rank: results}``; each rank runs ``rank_main``:

- ``row_parallel`` cases: ``ops/tp_overlap.row_parallel_dense`` on this
  rank's slice of a seeded ``x`` and ``w``, serial and chunked, with the
  collective counts;
- ``engine`` cases: a TP engine over the mesh, rank 0 driving (``lead``)
  and the others following, then each rank's own pool pages reported.
"""

from __future__ import annotations

import asyncio
import io
import tempfile
import traceback
from pathlib import Path

import numpy as np
import torch

from finchat_tpu_torch.engine.engine import InferenceEngine
from finchat_tpu_torch.engine.kv_cache import PageAllocator, pages_needed
from finchat_tpu_torch.models.quant import quantize
from finchat_tpu_torch.ops import tp_overlap
from finchat_tpu_torch.parallel.mesh import MeshSpec, build_mesh, initialize_distributed
from finchat_tpu_torch.parallel.ranks import Leader, RankChannel, follow

TIMEOUT_S = 60.0


def numpy_llama(vocab: int, dim: int, n_layers: int, n_heads: int, n_kv_heads: int,
                hidden: int, seed: int) -> dict:
    """A Llama tree of the packages' layout as fp32 numpy arrays (each
    matmul weight ``normal * fan_in ** -0.5``, norms ones), so both sides
    of a test take the same values without a JAX compile of the init."""
    rng = np.random.default_rng(seed)
    L, D, hd = n_layers, dim, dim // n_heads

    def rand(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    return {
        "embed": rand((vocab, D), D),
        "layers": {
            "attn_q": rand((L, D, n_heads * hd), D),
            "attn_k": rand((L, D, n_kv_heads * hd), D),
            "attn_v": rand((L, D, n_kv_heads * hd), D),
            "attn_o": rand((L, n_heads * hd, D), n_heads * hd),
            "ln_attn": np.ones((L, D), np.float32),
            "ln_mlp": np.ones((L, D), np.float32),
            "mlp_gate": rand((L, D, hidden), D),
            "mlp_up": rand((L, D, hidden), D),
            "mlp_down": rand((L, hidden, D), hidden),
        },
        "norm": np.ones((D,), np.float32),
        "lm_head": rand((D, vocab), D),
    }


# --- row_parallel_dense ---------------------------------------------------------------

def row_parallel_case(mesh, M: int, K: int, N: int, n_chunks: int, seed: int) -> dict:
    """This rank's slice of seeded ``x [M, K]`` and ``w [K, N]``; the serial
    and chunked results (fp32, bf16, int8 chunked once at placement), the
    overlapped form at one chunk (fp32, bf16, int8), and the collectives each
    issued."""
    tp, r = mesh.shape["model"], mesh.coords["model"]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    kl = K // tp
    xl, wl = x[:, r * kl:(r + 1) * kl].contiguous(), w[r * kl:(r + 1) * kl].contiguous()
    group = mesh.group("model")
    out = {}

    def run(name, xs, ws, overlap, chunks=n_chunks):
        tp_overlap.reset_collectives()
        out[name] = tp_overlap.row_parallel_dense(xs, ws, group, overlap=overlap,
                                                  n_chunks=chunks)
        out[name + "_collectives"] = tp_overlap.COLLECTIVES["row_parallel"]

    run("serial", xl, wl, False)
    run("overlap", xl, wl, True)
    run("overlap_one", xl, wl, True, 1)
    xb, wb = xl.bfloat16(), wl.bfloat16()
    run("serial_bf16", xb, wb, False)
    run("overlap_bf16", xb, wb, True)
    run("overlap_one_bf16", xb, wb, True, 1)
    wq = quantize(w)  # the scale spans every rank's rows, as a row-parallel leaf's does
    wq = type(wq)(q=wq.q[r * kl:(r + 1) * kl].contiguous(), scale=wq.scale)
    run("serial_int8", xl, wq, False)
    run("overlap_int8", xl, tp_overlap.chunk_row_parallel(wq, n_chunks), True)
    run("overlap_one_int8", xl, tp_overlap.chunk_row_parallel(wq, 1), True, 1)
    return out


# --- the TP engine --------------------------------------------------------------------

def drive(engine, prompt: list[int], n_new: int, slot: int = 0) -> dict:
    """A greedy turn at the engine's seams: pages for the turn, chunked
    prefill, the first token, ``n_new - 1`` decode steps; the tokens, the
    fp32 logits of every step, and the turn's pages offloaded."""
    ps = engine.page_size
    alloc = PageAllocator(engine.engine_cfg.num_pages)
    pages = alloc.allocate("s", pages_needed(len(prompt) + n_new, ps))
    engine.set_page_table_row(slot, pages)
    logits = engine.prefill(slot, list(prompt))
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
    return dict(tokens=tokens, logits=torch.stack(rows), pages=pages,
                record=engine.offload_pages(pages), written=len(prompt) + n_new - 1)


def next_turn(engine, record, n_ctx: int, new_ids: list[int], n_new: int, slot: int = 1) -> dict:
    """A conversation's next turn from a session record: the record restored
    into fresh pages of ``slot`` (and offloaded again from there: the round
    trip), its context length set, the new tokens prefilled at ``n_ctx``,
    then greedy decode."""
    ps, C = engine.page_size, engine.engine_cfg.prefill_chunk
    n_rec = -(-n_ctx // ps)
    total = pages_needed(n_ctx + len(new_ids) + n_new, ps)
    alloc = PageAllocator(engine.engine_cfg.num_pages)
    alloc.allocate("taken", 6)  # other pages than the first turn's
    pages = alloc.allocate("s2", total)
    engine.set_page_table_row(slot, pages)
    engine.restore_pages(pages[:n_rec], record)
    restored = engine.offload_pages(pages[:n_rec])  # the round trip, before the turn writes
    engine.set_context_lens_rows({slot: n_ctx})
    assert len(new_ids) <= C
    logits = engine.prefill_chunk([list(new_ids) + [0] * (C - len(new_ids))], [slot], [n_ctx],
                                  [len(new_ids)])[0]
    tok = engine.commit_first_token(slot, logits, 0.0, 1.0, 0)
    tokens = [int(tok)]
    B = engine.engine_cfg.max_seqs
    active = np.zeros(B, bool)
    active[slot] = True
    z, o, zk = np.zeros(B, np.float32), np.ones(B, np.float32), np.zeros(B, np.int32)
    for _ in range(n_new - 1):
        tokens.append(int(engine.decode(active, z, o, zk)[slot]))
    return dict(tokens=tokens, restored=restored)


def scheduler_run(engine, prompts: list[list[int]], n_new: int) -> list[list[int]]:
    """Greedy streams through the port's scheduler, every prompt submitted
    at once (prefill rounds coexist with decoding ones)."""
    from finchat_tpu_torch.engine.sampler import SamplingParams
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(engine, eos_id=-1)

    async def run():
        await sched.start()
        try:
            hs = [await sched.submit(f"s{i}", list(p), SamplingParams(temperature=0.0,
                                                                      max_new_tokens=n_new))
                  for i, p in enumerate(prompts)]
            out = []
            for h in hs:
                toks = []
                while True:
                    event = await asyncio.wait_for(h.events.get(), timeout=TIMEOUT_S)
                    if event["type"] == "done":
                        break
                    assert event["type"] == "token", event
                    toks.append(event["token_id"])
                out.append(toks)
            return out
        finally:
            await sched.stop()

    streams = asyncio.run(run())
    assert sched.allocator.used_count == 0
    return [[int(t) for t in s] for s in streams]


def engine_case(mesh, channel, case: dict) -> dict:
    """One engine case on every rank: rank 0 drives it through ``lead``, the
    others follow. Rank 0 returns what it drove; every rank returns its own
    pool's pages of the first turn."""
    kw = dict(device="cpu", quant=case.get("quant", ""), quant_group=case.get("group", 0))
    engine = InferenceEngine(case["config"], case["params"], case["ecfg"], mesh=mesh, **kw)
    out: dict = {}
    if mesh.rank == 0:
        leader = Leader(engine, channel)
        try:
            for step in case["steps"]:
                kind = step[0]
                if kind == "drive":
                    out["turn"] = drive(engine, *step[1:])
                elif kind == "round_trip":
                    t = out["turn"]
                    out["round_trip"] = next_turn(engine, t["record"], t["written"], *step[1:])
                elif kind == "restore_plain":
                    out["from_plain"] = next_turn(engine, case["plain_record"],
                                                  case["plain_written"], *step[1:])
                elif kind == "scheduler":
                    out["streams"] = scheduler_run(engine, *step[1:])
        finally:
            leader.stop()
    else:
        out["calls"] = follow(engine, channel)
    out["local_k"] = engine.state.k_pages.clone()
    out["local_v"] = engine.state.v_pages.clone()
    if engine.state.k_scales is not None:
        out["local_k_scales"] = engine.state.k_scales.clone()
    return out


def rank_main(rank: int, world: int, init_method: str, cases: dict, queue) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    results: dict = {}
    try:
        initialize_distributed(world, rank, backend="gloo", init_method=init_method,
                               timeout_s=TIMEOUT_S)
        try:
            mesh = build_mesh(MeshSpec(model=world), ["cpu"] * world)
            channel = RankChannel(mesh, TIMEOUT_S)
            for name, case in cases.items():
                if case["kind"] == "row_parallel":
                    results[name] = row_parallel_case(mesh, *case["args"])
                else:
                    results[name] = engine_case(mesh, channel, case)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results = {"error": traceback.format_exc()}
    # by value: a tensor pickled for a queue would be shared through a file
    # descriptor that dies with this process
    buf = io.BytesIO()
    torch.save(results, buf)
    queue.put((rank, buf.getvalue()))


def run_group(world: int, cases: dict, timeout_s: float = 240.0) -> dict:
    """Spawn ``world`` ranks over ``cases`` and collect every rank's results;
    raises with the first rank's traceback if one failed. Every rank is
    joined or terminated before this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = "file://" + str(Path(tempfile.mkdtemp(prefix="finchat-tp-test-")) / "store")
    procs = [ctx.Process(target=rank_main, args=(r, world, init, cases, queue), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    try:
        for _ in range(world):
            rank, res = queue.get(timeout=timeout_s)
            results[rank] = torch.load(io.BytesIO(res), weights_only=False)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    for rank in sorted(results):
        if "error" in results[rank]:
            raise RuntimeError(f"rank {rank} of {world} failed:\n{results[rank]['error']}")
    return results
