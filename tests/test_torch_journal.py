"""The port's answered-message journal (``io/journal.py``) against the JAX
package's: the same appends give byte-identical files, each package
replays the other's files, compaction and corrupt-record skips behave the
same, the legacy single file migrates to the same per-partition files, and
an append fault is logged and counted while serving goes on (after the
journal cases of tests/test_durability.py)."""

import itertools
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import finchat_tpu.io.journal as jjournal  # noqa: E402
from finchat_tpu.utils import faults as jfaults  # noqa: E402
from finchat_tpu.utils.metrics import METRICS as JMETRICS  # noqa: E402
import finchat_tpu_torch.io.journal as tjournal  # noqa: E402
from finchat_tpu_torch.utils import faults as tfaults  # noqa: E402
from finchat_tpu_torch.utils.metrics import METRICS as TMETRICS  # noqa: E402

SIDES = {"port": SimpleNamespace(J=tjournal.AnsweredJournal, faults=tfaults, metrics=TMETRICS),
         "jax": SimpleNamespace(J=jjournal.AnsweredJournal, faults=jfaults, metrics=JMETRICS)}


@pytest.fixture(autouse=True)
def _clock(monkeypatch):
    """A deterministic ``time.time_ns`` (the seq stamp's seed), restarted
    for each package by ``restart()``."""
    state = {}

    def restart():
        state["c"] = itertools.count(1_700_000_000_000_000_000, 1_000)

    restart()
    monkeypatch.setattr(time, "time_ns", lambda: next(state["c"]))
    yield restart
    tfaults.disarm_all()
    jfaults.disarm_all()


def _ids(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    pool = [f"mid-{i}" for i in range(12)] + [7, 42, "ü-✓", "quote\"d", None, 3.5]
    return [pool[int(i)] for i in rng.integers(0, len(pool), size=n)]


def _write(side, path, ids, parts: int, keep: int = 1024) -> None:
    j = side.J(str(path), keep=keep, num_partitions=parts)
    for i, mid in enumerate(ids):
        assert j.append(mid, partition=i % parts)
    j.close()


def _files(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("seed,parts", [(0, 1), (1, 4), (2, 8)])
def test_same_appends_same_bytes(seed, parts, tmp_path, _clock):
    ids = _ids(seed)
    for name, side in SIDES.items():
        _clock()
        _write(side, tmp_path / name, ids, parts)
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    assert len(got) == parts and all(v.startswith(b"v2 ") for v in got.values())


@pytest.mark.parametrize("keep", [3, 1024])
def test_each_replays_the_others_files(keep, tmp_path, _clock):
    ids = _ids(3)
    for name, side in SIDES.items():
        _clock()
        _write(side, tmp_path / name, ids, 4)
    replayed = {}
    for reader in SIDES:
        for writer in SIDES:
            d = tmp_path / f"{reader}-reads-{writer}"
            d.mkdir()
            for fname, data in _files(tmp_path / writer).items():
                (d / fname).write_bytes(data)
            replayed[(reader, writer)] = SIDES[reader].J(str(d), keep=keep,
                                                         num_partitions=4).replay()
            compacted = _files(d)
            replayed[(reader, writer, "files")] = compacted
    want = replayed[("jax", "jax")]
    for reader in SIDES:
        for writer in SIDES:
            assert replayed[(reader, writer)] == want
            assert replayed[(reader, writer, "files")] == replayed[("jax", "jax", "files")]
    assert len(want) == min(keep, len({repr(i) for i in ids}))


def test_compaction_and_corrupt_records_skip_the_same(tmp_path, _clock):
    out = {}
    for name, side in SIDES.items():
        _clock()
        d = tmp_path / name
        journal = side.J(str(d), keep=3)
        for mid in ("m1", "m2", "m3", "m1", 42):
            journal.append(mid)
        journal.close()
        with open(journal._part_path(0), "r+b") as f:
            lines = f.read().split(b"\n")
            lines[1] = b"v1 00000000 " + lines[1].split(b" ", 2)[2]  # bad crc
            f.seek(0)
            f.write(b"\n".join(lines) + b"v1 deadbe")  # torn final line
            f.truncate()
        q0 = side.metrics.get("finchat_durability_quarantines_total")
        r0 = side.metrics.get("finchat_durability_journal_replayed_total")
        first = side.J(str(d), keep=3).replay()
        second = side.J(str(d), keep=3).replay()
        out[name] = (first, second, _files(d),
                     side.metrics.get("finchat_durability_quarantines_total") - q0,
                     side.metrics.get("finchat_durability_journal_replayed_total") - r0)
    assert out["port"] == out["jax"]
    first, second, _f, quarantined, replayed = out["port"]
    assert first == second == ["m3", "m1", 42]
    assert quarantined == 2 and replayed == 6


def test_in_process_compaction_equal(tmp_path, _clock):
    """``8 * keep`` appends compact the written partitions in place."""
    for name, side in SIDES.items():
        _clock()
        _write(side, tmp_path / name, [f"m{i % 5}" for i in range(8 * 2 + 3)], 2, keep=2)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_legacy_file_migrates_the_same(tmp_path, _clock):
    import json
    import zlib

    legacy = b"".join(
        b"v1 %08x " % zlib.crc32(json.dumps(mid).encode()) + json.dumps(mid).encode() + b"\n"
        for mid in ["a", "b", 3, "c", "a"])
    for name, side in SIDES.items():
        _clock()
        d = tmp_path / name
        d.mkdir()
        (d / "answered.journal").write_bytes(legacy)
        j = side.J(str(d), num_partitions=4)
        assert not (d / "answered.journal").exists()
        assert j.replay(compact=False) == ["b", 3, "c", "a"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("side_name", ["port", "jax"])
def test_append_fault_logs_and_continues(side_name, tmp_path, caplog):
    side = SIDES[side_name]
    journal = side.J(str(tmp_path))
    side.faults.arm("journal.append", side.faults.one_shot(RuntimeError("disk full")))
    f0 = side.metrics.get("finchat_durability_journal_append_failures_total")
    a0 = side.metrics.get("finchat_durability_journal_appends_total")
    with caplog.at_level("ERROR"):
        assert journal.append("m1") is False
    assert any("disk full" in r.getMessage() for r in caplog.records)
    assert side.metrics.get("finchat_durability_journal_append_failures_total") == f0 + 1
    assert journal.append("m2") is True
    assert side.metrics.get("finchat_durability_journal_appends_total") == a0 + 1
    journal.close()
    assert side.J(str(tmp_path)).replay() == ["m2"]
