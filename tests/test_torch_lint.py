"""Static checks over the port.

- The JAX package's analyzer (``finchat_tpu.analysis``: event-loop
  blocking, host syncs on the hot path, metric and span discipline, the
  knob rule R4 over the port's ``load_config`` and README.md, ...) finds
  nothing unsuppressed in ``finchat_tpu_torch/``, and every suppression
  there is justified and used.
- Span discipline: every literal name passed to ``.mark(...)``,
  ``TRACER.event(...)``, ``TRACER.anomaly(...)`` or ``TRACER.span(...)``
  in the port is in the port's tracing registries. The analyzer's own rule
  keys on modules under ``finchat_tpu.``, which the port's are not, so the
  port walks its own files here; a misspelt name would otherwise vanish
  from every timeline without an error.
"""

import ast
from pathlib import Path

import pytest

from finchat_tpu.analysis import run_analysis
from finchat_tpu_torch.utils.tracing import ANOMALY_KINDS, SPAN_MARKS, TRACE_EVENT_NAMES

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "finchat_tpu_torch").rglob("*.py"))


def test_analyzer_finds_nothing_in_the_port():
    result = run_analysis(ROOT, [ROOT / "finchat_tpu_torch"])
    assert result.findings == [], "\n".join(map(str, result.findings))
    assert result.meta_findings == []
    assert result.unused_suppressions == []
    # the justified suppressions, each carried from the reference: the disk
    # tier's FIFO barrier; the journal's fsync-before-commit append and its
    # compaction rewrite (two findings each: the open and the fsync); the
    # memory broker's offsets file; the two config-file-only vector knobs
    # (R4)
    assert sorted(f.symbol for f, _s in result.suppressed) == [
        "AnsweredJournal._rewrite", "AnsweredJournal._rewrite",
        "AnsweredJournal.append", "AnsweredJournal.append",
        "InMemoryBroker._persist_offsets", "SessionDiskTier.flush",
        "VectorConfig", "VectorConfig"]
    assert all(s.justified for _f, s in result.suppressed)


def test_the_knob_rule_runs_over_the_port(tmp_path):
    """R4 reads the port's ``utils/config.py``: a field with no env var and
    no suppression is a finding there."""
    src = (ROOT / "finchat_tpu_torch" / "utils" / "config.py").read_text()
    bad = src.replace("    persist_path: str = \"\"  # snapshot directory",
                      "    unwired_knob: int = 0\n    persist_path: str = \"\"  # snapshot directory")
    assert bad != src
    (tmp_path / "utils").mkdir()
    (tmp_path / "utils" / "config.py").write_text(bad)
    (tmp_path / "README.md").write_text((ROOT / "README.md").read_text())
    result = run_analysis(tmp_path, [tmp_path / "utils"])
    assert [(f.rule, f.symbol) for f in result.findings] == [("knob-consistency", "VectorConfig")]
    assert "vector.unwired_knob" in result.findings[0].message


def _span_literals(path: Path) -> list[tuple[int, str, str]]:
    """(line, call, name) of every span/event call with a literal name."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr, owner = node.func.attr, node.func.value
        tracer_call = (attr in ("event", "anomaly", "span")
                       and isinstance(owner, ast.Name) and owner.id == "TRACER")
        if not (attr == "mark" or tracer_call):
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            found.append((node.lineno, "TRACER." + attr if tracer_call else attr,
                          node.args[0].value))
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_every_span_literal_is_registered(path):
    for line, call, name in _span_literals(path):
        registry = {"mark": SPAN_MARKS, "TRACER.anomaly": ANOMALY_KINDS}.get(
            call, TRACE_EVENT_NAMES)
        assert name in registry, f"{path.name}:{line}: {call}({name!r})"


def test_the_walk_sees_the_schedulers_literals_and_a_misspelling(tmp_path):
    names = {name for p in PORT_FILES for _l, _c, name in _span_literals(p)}
    assert {"admitted", "prefill_done", "first_token", "dispatch", "preempt", "adopt",
            "shed", "breaker_trip", "replica_give_up", "record_quarantine"} <= names
    bad = tmp_path / "bad.py"
    bad.write_text('span.mark("admited")\nTRACER.anomaly("breaker")\nTRACER.event(name)\n')
    assert _span_literals(bad) == [(1, "mark", "admited"), (2, "TRACER.anomaly", "breaker")]
    with pytest.raises(AssertionError, match="admited"):
        test_every_span_literal_is_registered(bad)
