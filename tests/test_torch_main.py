"""The port's CLI, ``python -m finchat_tpu_torch`` (``__main__.py``).

- Every flag makes the config overrides the JAX package's CLI makes (the
  JAX ``main`` is stopped at its ``load_config`` call to read them).
- Flags of planes the port does not carry yet reach ``build_app`` and are
  refused there by name; ``--decode-loop-depth`` builds and serves a turn.
- A subprocess drive at ``--preset stub --device cpu``: ``GET /health``,
  ``POST /transactions``, ``POST /chat`` over a real socket, then SIGTERM:
  exit 0 after the graceful drain, the vector snapshot written. A fresh
  process's in-memory store is empty, so the drive seeds it (one
  conversation) before it hands over to the module, which it runs as ``-m``
  runs it (``runpy.run_module(..., run_name="__main__")``).
"""

import asyncio
import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import finchat_tpu.__main__ as jmain  # noqa: E402
import finchat_tpu_torch.__main__ as tmain  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

EVERY_FLAG = [
    "--config", "cfg.json", "--preset", "mini", "--port", "9123", "--no-http",
    "--decode-loop-depth", "4", "--session-cache-bytes", "1024",
    "--request-deadline-seconds", "2.5", "--fleet-replicas", "3",
    "--fleet-roles", "prefill,decode,decode", "--fabric-path", "/fabric",
    "--journal-dir", "/journal", "--session-disk", "/sessions", "--flight-dir", "/flight",
    "--no-tracing", "--shutdown-deadline-seconds", "7",
]


class _Stop(Exception):
    pass


def _jax_overrides(monkeypatch, argv):
    seen = {}

    def capture(config_file, overrides):
        seen.update(config_file=config_file, overrides=overrides)
        raise _Stop

    monkeypatch.setattr(jmain, "load_config", capture)
    monkeypatch.setattr(sys, "argv", ["finchat_tpu", *argv])
    with pytest.raises(_Stop):
        jmain.main()
    return seen["config_file"], seen["overrides"]


@pytest.mark.parametrize("argv", [[], EVERY_FLAG, ["--preset", "stub", "--port", "0"]],
                         ids=["none", "every_flag", "port_0"])
def test_overrides_equal_the_jax_cli(monkeypatch, argv):
    args, overrides = tmain.parse_overrides(argv + ["--device", "cpu"])
    assert (args.config, overrides) == _jax_overrides(monkeypatch, argv)
    assert args.device == "cpu" and tmain.parse_overrides(argv)[0].device == "cuda"
    if argv is EVERY_FLAG:
        assert len(overrides) == 14 and overrides["fabric.enabled"] is True


@pytest.mark.parametrize("flags,name", [
    (["--fleet-replicas", "2"], None),
    (["--fleet-replicas", "2", "--fleet-roles", "prefill,decode"], None),
    (["--fabric-path", "<tmp>"], None),
    (["--decode-loop-depth", "2"], None),
], ids=["fleet_replicas", "fleet_roles", "fabric", "decode_loop"])
def test_unported_plane_flags_are_refused_by_name(monkeypatch, tmp_path, flags, name):
    """Every plane flag here is served (a refused one would raise by name).
    ``--decode-loop-depth 2`` (the fused decode loop), the fleet flags and
    ``--fabric-path`` build the app, which answers a ``/chat`` turn; with the
    stub preset it has no fleet and no fabric, as the JAX package's, and the
    same flags on ``tiny`` build an ``EngineFleet`` of the parsed roles, or
    one engine over a ``WarmFabric`` at the flag's ``fabric.path``."""
    flags = [str(tmp_path / "fabric") if f == "<tmp>" else f for f in flags]
    argv = ["--preset", "stub", "--device", "cpu", *flags]
    if name is not None:
        with pytest.raises(NotImplementedError, match=name.replace(".", r"\.")):
            tmain.main(argv)
        return
    import finchat_tpu_torch.serve.app as app_mod
    from finchat_tpu_torch.io.store import InMemoryStore
    from finchat_tpu_torch.serve.http import Request

    built = {}
    real_build = app_mod.build_app

    def build_then_turn(cfg, **kw):
        store = InMemoryStore(cfg)
        store.upsert_context("c1", {"user_id": "u1", "name": "Alex", "income": 5000,
                                    "savings_goal": 800})
        store.add_user_message("c1", "How am I doing?", "u1", timestamp=100)
        app = real_build(cfg, store=store, **kw)
        body = json.dumps({"conversation_id": "c1", "user_id": "u1", "message": "Any advice?"})
        resp = asyncio.run(app.chat(Request("POST", "/chat", {}, body.encode())))
        built.update(depth=cfg.engine.decode_loop_depth, status=resp.status,
                     body=json.loads(resp.body), fleet=app.fleet)
        if cfg.fleet.replicas > 1:
            # the same flags on a model: a fleet of the parsed roles
            small = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, preset="tiny"),
                engine=dataclasses.replace(cfg.engine, max_seqs=2, num_pages=16,
                                           max_seq_len=256, prefill_chunk=32,
                                           warmup_on_start=False, prefix_cache=False))

            async def no_rows(**_kw):
                return []

            fleet = real_build(small, store=store, retriever=no_rows, device="cpu").fleet
            built["roles"] = [r.role for r in fleet.replicas]
        if cfg.fabric.enabled:
            # the flag reached fabric.path: on a model, one engine over a fabric there
            small = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, preset="tiny"),
                engine=dataclasses.replace(cfg.engine, max_seqs=2, num_pages=16,
                                           max_seq_len=256, prefill_chunk=32,
                                           warmup_on_start=False, prefix_cache=False))

            async def no_rows(**_kw):
                return []

            fabric = real_build(small, store=store, retriever=no_rows,
                                device="cpu").scheduler.fabric
            built["fabric"] = (cfg.fabric.path, type(fabric).__name__, str(fabric.tier.path))
            fabric.close()
        raise _Stop

    monkeypatch.setattr(app_mod, "build_app", build_then_turn)
    with pytest.raises(_Stop):
        tmain.main(argv)
    roles = built.pop("roles", None)
    fabric = built.pop("fabric", None)
    assert built == {"depth": 2 if "--decode-loop-depth" in flags else 1, "status": 200,
                     "fleet": None, "body": {
                         "response": "I'm Penny, here to help with your finances.",
                         "retrieved_transactions_count": 0}}
    if "--fleet-replicas" in flags:
        assert roles == (["prefill", "decode"] if "--fleet-roles" in flags else
                         ["mixed", "mixed"])
    if "--fabric-path" in flags:
        want = str(tmp_path / "fabric")
        assert fabric == (want, "WarmFabric", want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


# runs the package as ``python -m`` does, after seeding the in-memory store
BOOTSTRAP = """
import runpy, sys
import finchat_tpu_torch.serve.app as app_mod
from finchat_tpu_torch.io.store import InMemoryStore

def seeded(cfg):
    store = InMemoryStore(cfg)
    store.upsert_context("c1", {"user_id": "u1", "name": "Alex", "income": 5000,
                                "savings_goal": 800})
    store.add_user_message("c1", "How am I doing?", "u1", timestamp=100)
    return store

app_mod.make_store = seeded
sys.argv = ["finchat_tpu_torch", *sys.argv[1:]]
runpy.run_module("finchat_tpu_torch", run_name="__main__", alter_sys=True)
"""


def test_cli_subprocess_serves_then_drains_on_sigterm(tmp_path):
    port = _free_port()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"serve.host": "127.0.0.1",
                               "vector.persist_path": str(tmp_path / "vectors")}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, "-c", BOOTSTRAP, "--preset", "stub", "--device", "cpu",
         "--config", str(cfg), "--port", str(port), "--journal-dir", str(tmp_path / "journal")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                health = _http(port, "GET", "/health")
                break
            except OSError:
                time.sleep(0.2)
        assert health == (200, '{"status": "healthy"}'), proc.poll()
        rows = [{"text": "Spent $4.50 at Blue Bottle Coffee", "amount": -4.5},
                {"text": "Rent payment $1800", "date": 2000.0}]
        assert _http(port, "POST", "/transactions", {"user_id": "u1", "transactions": rows}) \
            == (200, '{"upserted": 2}')
        status, body = _http(port, "POST", "/chat", {"conversation_id": "c1", "user_id": "u1",
                                                      "message": "Any advice?"})
        assert status == 200
        assert json.loads(body) == {"response": "I'm Penny, here to help with your finances.",
                                    "retrieved_transactions_count": 0}
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert "graceful drain" in out and "worker up: preset=stub" in out and "device=cpu" in out
    snap = tmp_path / "vectors" / "transactions"
    assert [json.loads(line)["payload"]["page_content"]
            for line in Path(str(snap) + ".jsonl").read_text().splitlines()] == \
        [r["text"] for r in rows]
    with np.load(str(snap) + ".npz") as data:
        assert data["vectors"].shape == (2, 64) and data["dates"][1] == 2000.0
