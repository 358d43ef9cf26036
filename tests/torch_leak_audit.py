"""The leak audit on the port's schedulers: tests/conftest.py's
``_finchat_leak_sanitizer`` (its leak half) for ``finchat_tpu_torch``.

A test module opts in by importing the fixture::

    from torch_leak_audit import port_scheduler_leak_audit  # noqa: F401

Every port ``ContinuousBatchingScheduler`` the test constructs is tracked;
after the test, each one that is stopped (or whose loop task is done) is
audited by the JAX package's ``analysis/sanitizers.scheduler_leak_report``:
stray page owners, slot accounting, duplicate free slots, prefix-head refs
against session entries and the allocator's own invariants. A report fails
the test. The stall half (a wall-clock check) is not taken.
"""

from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def port_scheduler_leak_audit():
    from finchat_tpu.analysis import sanitizers
    from finchat_tpu_torch.engine.scheduler import ContinuousBatchingScheduler

    kind = "port_scheduler"
    sanitizers.clear_tracked()
    with sanitizers.track_constructions(ContinuousBatchingScheduler, kind):
        yield
    problems: list[str] = []
    for sched in sanitizers.tracked_instances(kind):
        task = getattr(sched, "_task", None)
        if getattr(sched, "_running", False) and not (task and task.done()):
            continue  # still serving (a module-scoped fixture's): live streams hold pages
        problems += [f"{type(sched).__name__}[{getattr(sched, 'replica_id', '?')}]: {p}"
                     for p in sanitizers.scheduler_leak_report(sched)]
    sanitizers.clear_tracked()
    if problems:
        pytest.fail("leak audit (port scheduler):\n  " + "\n  ".join(problems), pytrace=False)
