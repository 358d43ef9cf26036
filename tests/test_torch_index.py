"""The port's on-device vector index (``embed/index.py``) against the JAX
package's, on the CPU.

- The same upserts give the same hit ids in the same order in both
  packages, on both query planes: over vectors whose scores are exact in
  fp32 (entries of +-0.5, four a vector, so every dot product is a sum of
  quarters), with duplicates, so the order among equal scores (the lower
  row first, ``jax.lax.top_k``'s) is what is held; and over random vectors.
- The batched plane equals the serial plane under every filter, the date
  filter is exact at the modern epoch, rows upserted after a first query
  are seen, growth past capacity, snapshots written by either package load
  in the other with equal hits, and ``save`` takes no lock during its file
  IO (tests/test_retrieval_plane.py, tests/test_ingestion.py,
  tests/test_embed.py); concurrent scoring scopes leave the process-wide
  TF32 flag as they found it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finchat_tpu.embed import index as jidx  # noqa: E402
from finchat_tpu_torch.embed import index as tidx  # noqa: E402

PACKAGES = {"jax": jidx, "port": tidx}


def _index(pkg, dim, capacity=1024):
    if pkg is tidx:
        return tidx.DeviceVectorIndex(dim=dim, initial_capacity=capacity, device="cpu")
    return jidx.DeviceVectorIndex(dim=dim, initial_capacity=capacity)


def _point(pkg, uid, date, text, vec):
    return pkg.VectorPoint(
        id=f"{uid}-{text}-{date}", vector=np.asarray(vec, np.float32),
        payload={"page_content": text, "metadata": {"user_id": uid, "date": date}},
    )


def _exact_vectors(rng, n, dim=16):
    """Vectors of four entries of +-0.5 (norm 1 exactly): every cosine is a
    sum of +-0.25 terms, exact in fp32 whatever the summation order."""
    out = np.zeros((n, dim), np.float32)
    for i in range(n):
        cols = rng.choice(dim, 4, replace=False)
        out[i, cols] = rng.choice([-0.5, 0.5], 4)
    return out


def _filters(rng, dim, vec=None):
    mk = (lambda: rng.normal(size=dim)) if vec is None else vec
    return [
        dict(vector=mk(), limit=5, user_id="u0"),
        dict(vector=mk(), limit=3, user_id="u1", date_gte=9_000.0),
        dict(vector=mk(), limit=50),
        dict(vector=mk(), limit=10, user_id="nobody"),
        dict(vector=mk(), limit=10, user_id="u2", date_gte=1e12),
        dict(vector=mk(), limit=40, user_id="u2"),
        dict(vector=mk(), limit=7, date_gte=20_000.0),
    ]


def _hits(pkg, index, specs):
    serial = [[p.id for p in index.query_points(
        np.asarray(s["vector"], np.float32), limit=s["limit"], user_id=s.get("user_id"),
        date_gte=s.get("date_gte"))] for s in specs]
    batched = [[p.id for p in hits] for hits in index.query_points_batch(
        [pkg.QuerySpec(np.asarray(s["vector"], np.float32), limit=s["limit"],
                       user_id=s.get("user_id"), date_gte=s.get("date_gte")) for s in specs])]
    return serial, batched


@pytest.mark.parametrize("kind", ["exact_ties", "random"])
def test_same_hits_in_the_same_order_as_the_jax_package(kind):
    rng = np.random.default_rng(7)
    if kind == "exact_ties":
        base = _exact_vectors(rng, 24)
        vecs = np.concatenate([base, base[:12], base[:6]])  # duplicates: equal scores
        queries = _exact_vectors(rng, 7)
        specs = _filters(rng, 16, vec=iter(queries).__next__)
    else:
        vecs = rng.normal(size=(37, 8)).astype(np.float32)
        specs = _filters(rng, 8)
    out = {}
    for name, pkg in PACKAGES.items():
        index = _index(pkg, vecs.shape[1], capacity=4)  # growth on the way
        points = [_point(pkg, f"u{i % 3}", float(i * 1000), f"t{i}", v)
                  for i, v in enumerate(vecs)]
        index.upsert(points[:10])
        index.query_points_batch([pkg.QuerySpec(vecs[0], limit=3)])
        index.upsert(points[10:])  # the incremental copy after a first query
        out[name] = _hits(pkg, index, specs)
    assert out["port"] == out["jax"]
    serial, batched = out["port"]
    assert serial == batched
    assert batched[3] == [] and batched[4] == []
    if kind == "exact_ties":
        # the duplicates really tie: some list holds a row and its copy
        texts = [{x.split("-")[1] for x in ids} for ids in serial]
        assert any(f"t{i}" in t and f"t{i + 24}" in t for t in texts for i in range(12))


def test_ties_go_to_the_lower_row():
    vecs = torch.zeros((6, 4))
    vecs[:, 0] = 1.0
    q = torch.tensor([[1.0, 0, 0, 0], [-1.0, 0, 0, 0]])
    mask = torch.ones((2, 6), dtype=torch.bool)
    mask[0, 1] = False
    scores, rows = tidx.score_topk(vecs, q, mask, 4)
    assert rows.tolist() == [[0, 2, 3, 4], [0, 1, 2, 3]]
    assert scores[0].tolist() == [1.0] * 4


def test_batch_topk_matches_serial_under_all_filters():
    rng = np.random.default_rng(11)
    index = _index(tidx, 8, capacity=4)
    points = [_point(tidx, f"u{i % 3}", float(i * 1000), f"txn {i}", rng.normal(size=8))
              for i in range(37)]
    index.upsert(points[:10])
    index.upsert(points[10:])
    serial, batched = _hits(tidx, index, _filters(rng, 8))
    assert serial == batched and batched[3] == [] and batched[4] == []


def test_batch_topk_date_filter_exact_at_modern_epoch():
    """Unix timestamps (~1.7e9) have 128 s spacing in float32: the device's
    (hi, lo) compare matches the host's float64 one to the second."""
    base = 1_700_000_000.0
    index = _index(tidx, 4, capacity=8)
    index.upsert([
        _point(tidx, "u", base + 10.0, "just inside", [1, 0, 0, 0]),
        _point(tidx, "u", base - 10.0, "just outside", [1, 0, 0, 0]),
        _point(tidx, "u", base, "exactly at cutoff", [1, 0, 0, 0]),
        _point(tidx, "u", base - 0.25, "a quarter second out", [1, 0, 0, 0]),
    ])
    spec = tidx.QuerySpec(np.asarray([1.0, 0, 0, 0]), limit=8, user_id="u", date_gte=base)
    batched = index.query_points_batch([spec])[0]
    serial = index.query_points(spec.vector, limit=8, user_id="u", date_gte=base)
    assert [p.id for p in batched] == [p.id for p in serial]
    assert {p.payload["page_content"] for p in batched} == {"just inside", "exactly at cutoff"}
    hi, lo = tidx._split_f64(np.asarray([base + 0.25, -np.inf]))
    assert hi.dtype == lo.dtype == np.float32 and lo[1] == 0.0
    assert float(hi[0]) + float(lo[0]) == base + 0.25


def test_batch_topk_sees_rows_upserted_after_first_query():
    index = _index(tidx, 4, capacity=8)
    index.upsert([_point(tidx, "u", 1.0, "old row", [0, 1, 0, 0])])
    index.query_points_batch([tidx.QuerySpec(np.asarray([1.0, 0, 0, 0]), limit=4)])
    index.upsert([_point(tidx, "u", 2.0, "new row", [1, 0, 0, 0])])
    hits = index.query_points_batch(
        [tidx.QuerySpec(np.asarray([1.0, 0, 0, 0]), limit=4, user_id="u")])[0]
    assert [h.payload["page_content"] for h in hits] == ["new row", "old row"]
    assert [h.payload["page_content"] for h in index.query_points(
        np.asarray([1.0, 0, 0, 0]), limit=4, user_id="u")] == ["new row", "old row"]


def test_growth_past_capacity():
    index = _index(tidx, 4, capacity=2)
    index.upsert([_point(tidx, "u", i, f"t{i}", np.eye(4)[i % 4]) for i in range(10)])
    assert len(index) == 10 and index._capacity == 16
    hits = index.query_points(np.asarray([1, 0, 0, 0], np.float32), limit=100, user_id="u")
    assert len(hits) == 10
    assert [h.id for h in hits[:3]] == ["u-t0-0", "u-t4-4", "u-t8-8"]


def test_filters_ranking_limit_and_empty():
    index = _index(tidx, 4, capacity=8)
    index.upsert([
        _point(tidx, "alice", 100, "exact", [1, 0, 0, 0]),
        _point(tidx, "alice", 900, "close", [0.9, 0.1, 0, 0]),
        _point(tidx, "alice", 100, "far", [0, 0, 1, 0]),
        _point(tidx, "bob", 100, "bob txn", [1, 0, 0, 0]),
    ])
    q = np.asarray([1, 0, 0, 0], np.float32)
    assert [h.payload["page_content"] for h in index.query_points(q, limit=2, user_id="alice")] \
        == ["exact", "close"]
    assert [h.payload["page_content"] for h in index.query_points(
        q, limit=10, user_id="alice", date_gte=500)] == ["close"]
    assert [h.payload["page_content"] for h in index.query_points(q, limit=10, user_id="bob")] \
        == ["bob txn"]
    assert _index(tidx, 4).query_points(np.zeros(4, np.float32), limit=5, user_id="u") == []
    assert _index(tidx, 4).query_points_batch([tidx.QuerySpec(q, limit=5)]) == [[]]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_snapshot_readable_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(9, 8)).astype(np.float32)
    src = _index(PACKAGES[writer], 8)
    src.upsert([_point(PACKAGES[writer], f"u{i % 2}", 1_700_000_000.0 + i * 3600,
                       f"txn {i}", v) for i, v in enumerate(vecs)])
    src._alive[3] = False  # a tombstone survives the snapshot
    base = str(tmp_path / "snap")
    src.save(base)
    pkg = PACKAGES[reader]
    dst = pkg.DeviceVectorIndex.load(base, dim=8, **({"device": "cpu"} if pkg is tidx else {}))
    assert len(dst) == 8
    specs = [dict(vector=rng.normal(size=8), limit=10, user_id="u1"),
             dict(vector=rng.normal(size=8), limit=4, user_id="u0",
                  date_gte=1_700_000_000.0 + 2 * 3600)]
    src_hits = _hits(PACKAGES[writer], src, specs)
    assert _hits(pkg, dst, specs) == src_hits
    assert "u1-txn 3-1700010800.0" not in src_hits[0][0]
    assert [p.payload for p in dst._points] == [p.payload for p in src._points]


def test_save_releases_lock_before_file_io(tmp_path, monkeypatch):
    index = _index(tidx, 4, capacity=8)
    index.upsert([_point(tidx, "u", 1.0, "row", [1, 0, 0, 0])])
    saw = {}
    orig = np.savez_compressed

    def probe(*args, **kwargs):
        saw["lock_free"] = index._lock.acquire(blocking=False)
        if saw["lock_free"]:
            index._lock.release()
        return orig(*args, **kwargs)

    monkeypatch.setattr(np, "savez_compressed", probe)
    index.save(str(tmp_path / "snap"))
    assert saw["lock_free"] is True
    assert len(tidx.DeviceVectorIndex.load(str(tmp_path / "snap"), dim=4, device="cpu")) == 1


def test_load_missing_and_torn_snapshots(tmp_path):
    assert len(tidx.DeviceVectorIndex.load(str(tmp_path / "absent"), dim=4, device="cpu")) == 0
    index = _index(tidx, 4)
    index.upsert([_point(tidx, "u", 1.0, f"r{i}", [1, 0, 0, 0]) for i in range(3)])
    base = str(tmp_path / "snap")
    index.save(base)
    lines = (tmp_path / "snap.jsonl").read_text().splitlines()
    (tmp_path / "snap.jsonl").write_text("\n".join(lines[:2]) + "\n")
    with pytest.raises(ValueError, match="torn snapshot"):
        tidx.DeviceVectorIndex.load(base, dim=4, device="cpu")


def test_concurrent_scoring_leaves_the_tf32_flag_as_it_was():
    """Scoring turns the process-wide TF32 flag off in its own scope from
    worker threads: concurrent scopes, of one index or several, see it off
    inside and leave it as it was."""
    import threading
    import time

    flag = torch.backends.cuda.matmul
    before = flag.allow_tf32
    seen = []

    def score():
        with tidx._ieee_fp32():
            seen.append(flag.allow_tf32)
            time.sleep(0.01)

    try:
        flag.allow_tf32 = True
        threads = [threading.Thread(target=score) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        after = flag.allow_tf32
    finally:
        flag.allow_tf32 = before
    assert (seen, after) == ([False] * 8, True)
