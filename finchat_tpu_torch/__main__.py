"""Process entrypoint: ``python -m finchat_tpu_torch`` (the CLI of the JAX
package's ``python -m finchat_tpu``, over the port's ``build_app``).

One process owns the engine on one card (or, with ``--fleet-replicas`` N,
N engine replicas over one parameter tree, ``--fleet-roles`` typing them
into prefill and serving pools; or, with ``mesh.model`` N, rank 0 of a
tensor-parallel group whose other ranks it spawns and stops); concurrency
comes from the continuous-batching scheduler, not from worker replication. The flags and
the config keys they override are the JAX package's. One flag is the
port's own: ``--device`` (default
``cuda``), the counterpart of the JAX package's ``JAX_PLATFORMS``; tests
pass ``cpu``.

SIGINT and SIGTERM start the graceful drain (``App.drain_and_stop``):
admission stops, in-flight streams get ``shutdown.deadline_seconds``, the
session entries spill and the vector index snapshots, then the process
exits 0. ``FINCHAT_DEV`` turns on asyncio's debug mode with a 100 ms
slow-callback threshold. Every environment variable of the reference
keeps working (utils/config.py).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal

from finchat_tpu_torch.utils.config import load_config
from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger("finchat_tpu_torch")


def parse_overrides(argv: list[str] | None = None) -> tuple[argparse.Namespace, dict]:
    """The parsed flags and the config overrides they make (the JAX
    package's keys, flag for flag)."""
    p = argparse.ArgumentParser(prog="finchat_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="JSON config file (see utils/config.py)")
    p.add_argument("--preset", default=None, help="model preset override")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--no-http", action="store_true", help="Kafka worker loop only")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine, the encoder and the vector index "
                        "(default cuda; cpu for tests and development)")
    p.add_argument("--decode-loop-depth", type=int, default=None,
                   help="tokens per fused decode dispatch; only 1 is served by the port "
                        "(build_app refuses more) — also FINCHAT_DECODE_LOOP_DEPTH")
    p.add_argument("--session-cache-bytes", type=int, default=None,
                   help="host-RAM byte budget of the session KV cache; 0 disables "
                        "cross-turn KV resume — also FINCHAT_SESSION_CACHE_BYTES")
    p.add_argument("--request-deadline-seconds", type=float, default=None,
                   help="per-request deadline (Kafka producer timestamp + this): pending "
                        "requests past it are shed with a retryable error and admission "
                        "goes earliest-deadline-first; 0 = off — also "
                        "FINCHAT_REQUEST_DEADLINE_SECONDS")
    p.add_argument("--fleet-replicas", type=int, default=None,
                   help="engine replicas of this worker, over one parameter tree behind "
                        "the conversation-affinity router — also FINCHAT_FLEET_REPLICAS")
    p.add_argument("--fleet-roles", default=None,
                   help="per-replica roles, e.g. 'prefill,decode,decode': prefill replicas "
                        "run cold prompts and hand the KV to the serving pool — also "
                        "FINCHAT_FLEET_ROLES")
    p.add_argument("--fabric-path", default=None,
                   help="cluster-wide warm-state fabric directory (engine/warm_fabric.py): "
                        "one shared session disk tier and holder index, so any replica "
                        "resumes any conversation warm and the shared prompt heads prefill "
                        "once a fleet; implies fabric.enabled — also FINCHAT_FABRIC_PATH")
    p.add_argument("--journal-dir", default=None,
                   help="durability directory (io/journal.py): answered message ids are "
                        "journaled here (fsync before the Kafka commit) and replayed into "
                        "the dedupe ring at restart — also FINCHAT_JOURNAL_PATH")
    p.add_argument("--session-disk", default=None,
                   help="session-KV disk tier directory: entries write through to "
                        "checksummed records so a restarted process resumes warm — also "
                        "FINCHAT_SESSION_CACHE_DISK")
    p.add_argument("--flight-dir", default=None,
                   help="flight-recorder directory: on an anomaly (breaker trip, watchdog, "
                        "shed, SIGTERM) the trace ring dumps to a checksummed file here — "
                        "also FINCHAT_TRACING_FLIGHT_DIR")
    p.add_argument("--no-tracing", action="store_true",
                   help="disable request tracing and the flight recorder (tracing.enabled; "
                        "also FINCHAT_TRACING=0)")
    p.add_argument("--shutdown-deadline-seconds", type=float, default=None,
                   help="graceful SIGTERM drain window: in-flight streams may finish for "
                        "this long before the stragglers are preempted with a retryable "
                        "error — also FINCHAT_SHUTDOWN_DEADLINE_SECONDS")
    args = p.parse_args(argv)

    overrides: dict = {}
    if args.preset:
        overrides["model.preset"] = args.preset
    if args.port:
        overrides["serve.port"] = args.port
    if args.decode_loop_depth is not None:
        overrides["engine.decode_loop_depth"] = args.decode_loop_depth
    if args.session_cache_bytes is not None:
        overrides["engine.session_cache_bytes"] = args.session_cache_bytes
    if args.request_deadline_seconds is not None:
        overrides["engine.request_deadline_seconds"] = args.request_deadline_seconds
    if args.fleet_replicas is not None:
        overrides["fleet.replicas"] = args.fleet_replicas
    if args.fleet_roles is not None:
        overrides["fleet.roles"] = args.fleet_roles
    if args.fabric_path is not None:
        overrides["fabric.path"] = args.fabric_path
        overrides["fabric.enabled"] = True
    if args.journal_dir is not None:
        overrides["journal.path"] = args.journal_dir
    if args.session_disk is not None:
        overrides["engine.session_cache_disk_path"] = args.session_disk
    if args.shutdown_deadline_seconds is not None:
        overrides["shutdown.deadline_seconds"] = args.shutdown_deadline_seconds
    if args.flight_dir is not None:
        overrides["tracing.flight_dir"] = args.flight_dir
    if args.no_tracing:
        overrides["tracing.enabled"] = False
    return args, overrides


def main(argv: list[str] | None = None) -> None:
    args, overrides = parse_overrides(argv)
    cfg = load_config(args.config, overrides)

    from finchat_tpu_torch.serve.app import build_app

    app = build_app(cfg, device=args.device)

    async def run() -> None:
        loop = asyncio.get_running_loop()
        if os.getenv("FINCHAT_DEV"):
            # a callback that blocks the loop (a sync store call, a blocking
            # poll) shows up loudly in dev mode
            loop.set_debug(True)
            loop.slow_callback_duration = 0.1
            logger.info("dev diagnostics on: asyncio debug + slow-callback detection")
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await app.start(serve_http=not args.no_http)
        logger.info("worker up: preset=%s http=%s port=%d device=%s",
                    cfg.model.preset, not args.no_http, cfg.serve.port, args.device)
        await stop.wait()
        # graceful drain: stop admission, finish in-flight streams within
        # shutdown.deadline_seconds, preempt the stragglers with a
        # retryable error, spill the session entries to the disk tier,
        # journal and commit, snapshot the vector index, and exit with no
        # slot or page left: a restarted process resumes warm
        logger.info("shutting down (graceful drain, deadline %.0fs)",
                    cfg.shutdown.deadline_seconds)
        await app.drain_and_stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
