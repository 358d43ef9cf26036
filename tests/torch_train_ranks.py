"""The rank side of tests/test_torch_train_parallel.py and
tests/test_torch_pipeline.py: what each spawned gloo rank runs. It imports
only torch and the port (a spawned rank never imports JAX), and hands its
results back through a queue, by value.

``World(world, cases)`` spawns ``world`` CPU ranks once (a fresh
``file://`` rendezvous, a 60 s collective timeout, every join and queue
read bounded) and runs every case on every rank in order; a case names the
world ranks its mesh spans (``parallel/mesh.build_mesh(..., ranks=...)``:
every rank makes every group, the ranks outside the mesh skip the case).
Kinds:

- ``train``: ``train/train_step`` over the mesh: the logits of the whole
  batch (``forward`` on the rank's shard), ``value_and_grad`` on the rank's
  batch slice with the collectives it issued, and the losses of
  ``make_train_step``; with ``one_device`` the same steps on the whole tree
  with no mesh beside them;
- ``pipeline``: ``parallel/pipeline``: ``pipeline_forward`` at each
  ``(n_micro, positions, tp_overlap)`` and ``make_pipeline_train_step``'s
  losses, with every leaf's gradient of its first step;
- ``row_parallel_grad``: ``ops/tp_overlap.row_parallel_dense`` forward and
  backward, serial and chunked, on this rank's slice of a seeded problem.
"""

from __future__ import annotations

import io
import tempfile
import traceback
from pathlib import Path

import numpy as np
import torch

from finchat_tpu_torch.models.llama import LlamaConfig, forward, make_causal_attention
from finchat_tpu_torch.ops import tp_overlap
from finchat_tpu_torch.parallel import collectives, pipeline
from finchat_tpu_torch.parallel.mesh import AXES, MeshSpec, build_mesh, initialize_distributed
from finchat_tpu_torch.parallel.sharding import llama_param_shardings, shard_batch, shard_params
from finchat_tpu_torch.train import train_step as ttrain

TIMEOUT_S = 60.0


def numpy_tree(cfg: dict, seed: int) -> dict:
    """A Llama tree of the packages' layout (dense, or MoE with
    ``n_experts``) as fp32 numpy arrays: each matmul weight ``normal *
    fan_in ** -0.5``, norms ones, the router too (fp32 in both packages)."""
    rng = np.random.default_rng(seed)
    L, D, H, Hkv = cfg["n_layers"], cfg["dim"], cfg["n_heads"], cfg["n_kv_heads"]
    F, V, E, hd = cfg["hidden_dim"], cfg["vocab_size"], cfg.get("n_experts", 0), D // H

    def rand(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    layers = {
        "attn_q": rand((L, D, H * hd), D),
        "attn_k": rand((L, D, Hkv * hd), D),
        "attn_v": rand((L, D, Hkv * hd), D),
        "attn_o": rand((L, H * hd, D), H * hd),
        "ln_attn": np.ones((L, D), np.float32),
        "ln_mlp": np.ones((L, D), np.float32),
    }
    if E:
        layers.update(router=rand((L, D, E), D), moe_gate=rand((L, E, D, F), D),
                      moe_up=rand((L, E, D, F), D), moe_down=rand((L, E, F, D), F))
    else:
        layers.update(mlp_gate=rand((L, D, F), D), mlp_up=rand((L, D, F), D),
                      mlp_down=rand((L, F, D), F))
    return {"embed": rand((V, D), D), "layers": layers, "norm": np.ones((D,), np.float32),
            "lm_head": rand((D, V), D)}


def torch_config(cfg: dict, dtype: torch.dtype) -> LlamaConfig:
    return LlamaConfig(**cfg, dtype=dtype)


def torch_tree(tree: dict, dtype: torch.dtype) -> dict:
    """``tree`` as torch tensors of ``dtype`` (the router stays fp32)."""
    def conv(name, a):
        t = torch.from_numpy(np.array(a))
        return t if name == "router" else t.to(dtype)

    return {k: ({n: conv(n, a) for n, a in v.items()} if isinstance(v, dict) else conv(k, v))
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}/")
        else:
            yield prefix + name, value


def _steps(params, cfg, mesh, tokens, lr: float, steps: int, shard: bool) -> tuple[list, dict]:
    """``steps`` AdamW steps of ``make_train_step``; the losses and the
    parameters after them."""
    opt = ttrain.make_optimizer(learning_rate=lr)
    state = ttrain.init_train_state(cfg, params, opt)
    step = ttrain.make_train_step(cfg, opt, mesh)
    batch = shard_batch(tokens, mesh) if shard else tokens
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(loss.detach().clone())
    return losses, {p: t.detach().clone() for p, t in _leaves(state.params)}


def train_case(mesh, case: dict) -> dict:
    dtype = case.get("dtype", torch.float32)
    cfg = torch_config(case["cfg"], dtype)
    tokens = torch.from_numpy(case["tokens"])

    def local():
        return shard_params(torch_tree(case["tree"], dtype), llama_param_shardings(mesh), mesh)

    out: dict = {"coords": mesh.coords}
    if "logit_tokens" in case:
        t = torch.from_numpy(case["logit_tokens"])
        positions = torch.arange(t.shape[1]).expand(t.shape)
        with torch.no_grad():
            out["logits"], _ = forward(local(), t, positions,
                                       config=ttrain.mesh_config(cfg, mesh),
                                       attention=make_causal_attention())
    if case.get("grads"):
        collectives.reset_collectives()
        tp_overlap.reset_collectives()
        out["loss"], out["grads"] = ttrain.value_and_grad(local(), shard_batch(tokens, mesh),
                                                          config=cfg, mesh=mesh)
        out["collectives"] = {**collectives.COLLECTIVES, **tp_overlap.COLLECTIVES}
    if case.get("steps"):
        out["losses"], out["params"] = _steps(local(), cfg, mesh, tokens, case["lr"],
                                              case["steps"], shard=True)
    if case.get("one_device"):
        whole = torch_tree(case["tree"], dtype)
        out["plain_loss"], out["plain_grads"] = ttrain.value_and_grad(whole, tokens, config=cfg)
        out["plain_losses"], out["plain_params"] = _steps(torch_tree(case["tree"], dtype), cfg,
                                                          None, tokens, case["lr"],
                                                          case["steps"], shard=False)
    return out


def pipeline_case(mesh, case: dict) -> dict:
    dtype = case.get("dtype", torch.float32)
    cfg = torch_config(case["cfg"], dtype)
    tokens = torch.from_numpy(case["tokens"])
    local = pipeline.shard_params_for_pipeline(torch_tree(case["tree"], dtype), mesh, cfg)
    out: dict = {"coords": mesh.coords}
    for key, (n_micro, positions, overlap) in case.get("forwards", {}).items():
        out[key] = pipeline.pipeline_forward(local, tokens, torch.from_numpy(positions),
                                             config=cfg, mesh=mesh, n_micro=n_micro,
                                             tp_overlap=overlap)
    if case.get("steps"):
        opt = ttrain.make_optimizer(learning_rate=case["lr"])
        state = ttrain.init_train_state(cfg, local, opt)
        step = pipeline.make_pipeline_train_step(cfg, opt, mesh, n_micro=case["n_micro"])
        out["losses"] = []
        for i in range(case["steps"]):
            state, loss = step(state, tokens)
            out["losses"].append(loss.detach().clone())
            if i == 0:
                out["grads"] = {p: t.grad.clone() for p, t in _leaves(state.params)}
    return out


def row_parallel_grad_case(mesh, case: dict) -> dict:
    """This rank's slice of seeded ``x [B, S, K]`` and ``w [K, N]``: the
    row-parallel output and the gradients of ``x`` and ``w`` for a seeded
    output gradient, serial and chunked (fp32)."""
    tp, r = mesh.shape["model"], mesh.coords["model"]
    rng = np.random.default_rng(case["seed"])
    B, S, K, N = case["shape"]
    x = torch.from_numpy(rng.standard_normal((B, S, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, N)).astype(np.float32))
    kl = K // tp
    out = {}
    for name, overlap in (("serial", False), ("overlap", True)):
        xl = x[..., r * kl:(r + 1) * kl].clone().requires_grad_()
        wl = w[r * kl:(r + 1) * kl].clone().requires_grad_()
        y = tp_overlap.row_parallel_dense(xl, wl, mesh.group("model"), overlap=overlap,
                                          n_chunks=case["n_chunks"])
        y.backward(g)
        out[name] = (y.detach(), xl.grad, wl.grad)
    return out


KINDS = {"train": train_case, "pipeline": pipeline_case, "row_parallel_grad": row_parallel_grad_case}


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
            meshes: dict = {}
            for name, case in cases.items():
                key = (case["sizes"], case["ranks"])
                if key not in meshes:
                    meshes[key] = build_mesh(MeshSpec(**dict(zip(AXES, case["sizes"]))),
                                             ["cpu"] * len(case["ranks"]), "gloo",
                                             ranks=list(case["ranks"]), timeout_s=TIMEOUT_S)
                if meshes[key] is not None:
                    results[name] = KINDS[case["kind"]](meshes[key], case)
        finally:
            dist.destroy_process_group()
    except Exception:  # the process's boundary: the parent reports it
        results = {"error": traceback.format_exc()}
    # by value: a tensor pickled for a queue would be shared through a file
    # descriptor that dies with this process
    buf = io.BytesIO()
    torch.save(results, buf)
    queue.put((rank, buf.getvalue()))


class World:
    """``world`` ranks spawned over ``cases`` at construction; ``results()``
    waits for every rank's results (raising with the first failed rank's
    traceback), so the caller can work while they run. ``close()`` joins
    or terminates every rank. ``target``: the rank's function, ``rank_main``'s
    signature (another rank module's)."""

    def __init__(self, world: int, cases: dict, target=None):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        tmp = Path(tempfile.mkdtemp(prefix="finchat-train-test-"))
        init = "file://" + str(tmp / "store")
        # the cases by file: a start's arguments larger than a pipe's buffer
        # would hold the parent until the child has imported torch, one rank
        # after the other
        torch.save(cases, tmp / "cases.pt")
        self.procs = [ctx.Process(target=target or rank_main,
                                  args=(r, world, init, str(tmp / "cases.pt"), self.queue),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self._results: dict | None = None

    def results(self, timeout_s: float = 240.0) -> dict:
        if self._results is None:
            results: dict = {}
            try:
                for _ in self.procs:
                    rank, res = self.queue.get(timeout=timeout_s)
                    results[rank] = torch.load(io.BytesIO(res), weights_only=False)
            finally:
                self.close()
            for rank in sorted(results):
                if "error" in results[rank]:
                    raise RuntimeError(f"rank {rank} of {len(self.procs)} failed:\n"
                                       f"{results[rank]['error']}")
            self._results = results
        return self._results

    def close(self, timeout_s: float = 30.0) -> None:
        """Join every rank within ``timeout_s`` (reading what a rank still
        has to put: a rank does not exit before its queue is flushed), then
        terminate the rest."""
        import queue as queue_mod
        import time

        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in self.procs) and time.monotonic() < deadline:
            try:
                self.queue.get(timeout=0.2)
            except queue_mod.Empty:
                pass
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)


# --- the pytest side's helpers ------------------------------------------------------------

def spec_slices(spec: tuple, shape: tuple, coords: dict, sizes: tuple) -> tuple:
    """The index of a rank's shard in the whole leaf under ``spec`` (a
    dim's axes combine row-major, the first outermost)."""
    shape_of = dict(zip(AXES, sizes))
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        extent, idx = 1, 0
        for a in axes:
            extent *= shape_of[a]
            idx = idx * shape_of[a] + coords[a]
        size = n // extent
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def gather(ranks: dict, key: str, want: dict, sizes: tuple, specs: dict) -> dict:
    """Each leaf's whole value (``want``'s shapes) placed from the ranks'
    shards of it (``res[key]``, a tree) under ``specs`` (by leaf path)."""
    full = {p: np.zeros(np.shape(w), np.float32) for p, w in want.items()}
    for res in ranks.values():
        for path, g in _leaves(res[key]):
            full[path][spec_slices(specs[path], np.shape(want[path]), res["coords"],
                                   sizes)] = g.float().numpy()
    return full
