"""Fault injection registry (own copy of the JAX package's).

Production code calls ``inject(site, **ctx)`` at named sites (a no-op
unless a handler is armed), and tests arm handlers that raise to drive the
degradation contracts:

- the circuit breaker: ``scheduler.decode`` (every decode step and every
  ragged round), ``scheduler.mixed`` (the ragged round alone) and
  ``engine.rebuild`` (the device-state rebuild of ``revive_async``);
- per-sequence isolation: ``scheduler.prefill`` fires for each sequence of
  a prefill or ragged round, and a fault there evicts that one sequence
  with an error event while the others keep serving;
- the session tier: ``session.restore`` (a failed copy back at admission
  cold-starts the conversation) and ``session.offload`` (a failed snapshot
  at retirement never fails the retiring stream);
- the durability plane: ``disk.spill`` (a failed record write never fails
  the stream) and ``disk.restore`` (a failed read quarantines the record
  and cold-starts the conversation);
- the agent: ``tool.execute`` fires inside every tool execution,
  speculative and serial (``agent/graph.py`` ``_execute_tool``), so a test
  can fail an eagerly launched tool mid-decode and see the serial retry.

Sites are plain strings; ``ctx`` carries site-specific identifiers (e.g.
``seq_id``) so a handler can target one victim.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Iterator

Handler = Callable[..., None]

_lock = threading.Lock()
_handlers: dict[str, Handler] = {}


def inject(site: str, **ctx: Any) -> None:
    """Production-side hook: no-op unless a handler is armed for ``site``.
    A handler that raises propagates into the site's own error handling;
    that propagation is the injected fault."""
    handler = _handlers.get(site)
    if handler is not None:
        handler(**ctx)


def arm(site: str, handler: Handler) -> None:
    with _lock:
        _handlers[site] = handler


def disarm(site: str) -> None:
    with _lock:
        _handlers.pop(site, None)


def disarm_all() -> None:
    with _lock:
        _handlers.clear()


@contextmanager
def armed(site: str, handler: Handler) -> Iterator[None]:
    """Scoped arming."""
    arm(site, handler)
    try:
        yield
    finally:
        disarm(site)


def one_shot(exc: Exception) -> Handler:
    """Handler that raises ``exc`` exactly once, then passes: a transient
    fault (the retry or degrade path must recover)."""
    fired = threading.Event()

    def handler(**_ctx: Any) -> None:
        if not fired.is_set():
            fired.set()
            raise exc

    return handler


def n_shot(n: int, exc: Exception) -> Handler:
    """Handler that raises ``exc`` exactly ``n`` times, then passes: a
    bounded outage (the breaker's consecutive-failure threshold is exactly
    this shape)."""
    remaining = [n]

    def handler(**_ctx: Any) -> None:
        if remaining[0] > 0:
            remaining[0] -= 1
            raise exc

    return handler
