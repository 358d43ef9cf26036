"""On-device vector index (own copy of the JAX package's ``embed/index.py``,
in PyTorch).

Exact brute-force cosine over the whole collection: one ``V @ Q^T`` product
per search. Two query planes give the same hits:

- ``query_points``: the serial host-mask path. The filter mask is built in
  numpy per query, then one scoring call.
- ``query_points_batch``: B queries score in one call, and the
  must-filters (user_id equality, date >= bound) are evaluated on the
  device against int-coded filter columns kept there and updated
  incrementally on upsert: new rows are copied into their slice in place,
  the matrix is uploaded whole only when the capacity doubles.

Scoring is true fp32 (TF32 off for the product), and among equal scores
the lower row comes first, as ``jax.lax.top_k`` orders them: duplicate
transactions embed to identical vectors, so ties are common. Dates stay
exact: a float64 date is kept on the device as a float32 (hi, lo) pair and
compared lexicographically, never promoted to float64 there.

Data model (the reference's Qdrant points): a point carries the payload
``{page_content: str, metadata: {user_id, date: unix-ts, ...}}``; filters
are ``must user_id == X`` plus an optional ``metadata.date >= now - N
days``. ``save``/``load`` write and read the JAX package's snapshot format
(``<base>.npz`` holding ``vectors``, ``dates`` and ``alive``, and
``<base>.jsonl`` holding one ``{"id", "payload"}`` a line), so either
package reads the other's snapshot.

The index lives on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from finchat_tpu_torch.utils.logging import get_logger
from finchat_tpu_torch.utils.precision import ieee_fp32 as _ieee_fp32

logger = get_logger(__name__)

# user-code sentinels for the device-side filter: NO_FILTER matches every
# row; NO_MATCH (an unknown user_id, which no row can carry) matches none
NO_FILTER_CODE = -1
NO_MATCH_CODE = -2


@dataclass
class VectorPoint:
    id: str
    vector: np.ndarray  # [dim] fp32 (normalized or not; upsert normalizes)
    payload: dict[str, Any] = field(default_factory=dict)

    @property
    def metadata(self) -> dict[str, Any]:
        return self.payload.get("metadata", {}) or {}


@dataclass(frozen=True)
class QuerySpec:
    """One query of a batched ``query_points_batch`` call."""

    vector: np.ndarray
    limit: int
    user_id: str | None = None
    date_gte: float | None = None


def _split_f64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Double-single split: float64 -> (hi, lo) float32 pair with ``hi + lo
    == x`` to ~48 bits. A unix timestamp (~2^31 s) has 128 s spacing in
    float32, so a single float32 date column would mis-filter rows within
    two minutes of the cutoff; the lexicographic (hi, lo) compare is exact
    to well under a millisecond."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    # -inf encodes "no date filter": its hi alone decides every compare,
    # so lo is 0 there (inf - inf would be NaN)
    finite = np.isfinite(x)
    lo = np.zeros_like(x)
    np.subtract(x, hi.astype(np.float64), out=lo, where=finite)
    return hi, lo.astype(np.float32)


@torch.inference_mode()
def score_topk(vectors: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``scores = Q @ V^T`` ([B, N], IEEE fp32) with the rows outside
    ``mask`` ([B, N] bool) at -inf; returns the top ``k`` of each query as
    ([B, k] scores, [B, k] rows), best first, the lower row first among
    equal scores. The order is exact: each score's bits, made monotonic as
    a signed int, are the high half of an int64 key whose low half is
    ``N - 1 - row``, and the top-k runs over the keys, which are distinct."""
    N = vectors.shape[0]
    with _ieee_fp32():
        scores = q @ vectors.T
    # + 0.0 turns -0.0 into +0.0: the two compare equal as scores
    scores = torch.where(mask, scores + 0.0, torch.full_like(scores, float("-inf")))
    bits = scores.view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # float order as signed int order
    rows = torch.arange(N, dtype=torch.int64, device=vectors.device)
    key = ordered.to(torch.int64) * (1 << 32) + (N - 1 - rows)
    idx = torch.topk(key, k, dim=-1).indices
    return scores.gather(-1, idx), idx


@torch.inference_mode()
def batch_mask(alive: torch.Tensor, user_codes: torch.Tensor, dates_hi: torch.Tensor,
               dates_lo: torch.Tensor, q_codes: torch.Tensor, q_date_hi: torch.Tensor,
               q_date_lo: torch.Tensor) -> torch.Tensor:
    """[B, N] must-filter mask built on the device from the resident
    columns: alive, the user code (``NO_FILTER_CODE`` matches every row),
    and date >= the query's cutoff as a lexicographic compare of the
    (hi, lo) pairs, exact because both sides come from the same split."""
    user_ok = (q_codes[:, None] == NO_FILTER_CODE) | (user_codes[None, :] == q_codes[:, None])
    hi_n, lo_n = dates_hi[None, :], dates_lo[None, :]
    hi_q, lo_q = q_date_hi[:, None], q_date_lo[:, None]
    date_ok = (hi_n > hi_q) | ((hi_n == hi_q) & (lo_n >= lo_q))
    return alive[None, :] & user_ok & date_ok


class DeviceVectorIndex:
    """Append-mostly vector store with scoring on the device.

    The host keeps payloads and the filter columns (user code, date, alive)
    as numpy; the device keeps a padded, L2-normalized matrix ``[capacity,
    dim]`` fp32 and its filter columns. Capacity doubles on overflow (a
    full re-upload); within a capacity, new rows are copied into their
    slice. Deletes are tombstones.
    """

    def __init__(self, dim: int, initial_capacity: int = 1024,
                 device: torch.device | str = "cuda"):
        self.dim = dim
        self.device = torch.device(device)
        self._lock = threading.Lock()
        # serializes whole snapshots against each other (two concurrent
        # save() calls would race on the same .tmp paths) without making
        # queries wait on compression or file IO
        self._save_lock = threading.Lock()
        self._capacity = initial_capacity
        self._count = 0
        self._points: list[VectorPoint] = []
        self._user_ids: list[str] = []
        # one int per distinct user_id, kept up to date on upsert, so no
        # query rebuilds an array from the Python string list
        self._user_interner: dict[str, int] = {}
        self._user_codes = np.full((initial_capacity,), NO_MATCH_CODE, np.int32)
        self._dates = np.zeros((initial_capacity,), np.float64)
        self._alive = np.zeros((initial_capacity,), bool)
        self._host_vectors = np.zeros((initial_capacity, dim), np.float32)
        self._synced_rows = 0  # device rows that mirror the host arrays
        self._full_dirty = True  # growth / external mutation: upload all
        self._device: dict[str, torch.Tensor] = {}

    def __len__(self) -> int:
        return int(self._alive[: self._count].sum())

    @staticmethod
    def _normalize(v: np.ndarray) -> np.ndarray:
        norm = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / np.maximum(norm, 1e-9)

    def _intern(self, user_id: str) -> int:
        code = self._user_interner.get(user_id)
        if code is None:
            code = len(self._user_interner)
            self._user_interner[user_id] = code
        return code

    def _grow(self, needed: int) -> None:
        new_cap = self._capacity
        while new_cap < needed:
            new_cap *= 2
        pad = new_cap - self._capacity
        self._host_vectors = np.concatenate(
            [self._host_vectors, np.zeros((pad, self.dim), np.float32)])
        self._dates = np.concatenate([self._dates, np.zeros((pad,), np.float64)])
        self._alive = np.concatenate([self._alive, np.zeros((pad,), bool)])
        self._user_codes = np.concatenate(
            [self._user_codes, np.full((pad,), NO_MATCH_CODE, np.int32)])
        self._capacity = new_cap
        self._full_dirty = True  # the device arrays are rebuilt at the new shape

    def upsert(self, points: list[VectorPoint]) -> None:
        with self._lock:
            if self._count + len(points) > self._capacity:
                self._grow(self._count + len(points))
            for p in points:
                row = self._count
                self._host_vectors[row] = self._normalize(np.asarray(p.vector, np.float32))
                self._dates[row] = float(p.metadata.get("date", 0) or 0)
                self._alive[row] = True
                self._points.append(p)
                uid = str(p.metadata.get("user_id", ""))
                self._user_ids.append(uid)
                self._user_codes[row] = self._intern(uid)
                self._count += 1

    def _host_columns(self, lo: int, hi: int) -> dict[str, np.ndarray]:
        d_hi, d_lo = _split_f64(self._dates[lo:hi])
        return dict(vectors=self._host_vectors[lo:hi], alive=self._alive[lo:hi],
                    user_codes=self._user_codes[lo:hi], dates_hi=d_hi, dates_lo=d_lo)

    def _sync_device(self) -> None:
        """Bring the device columns up to date with the host arrays: a full
        upload after growth or an external mutation, otherwise a copy of
        the rows added since the last sync into their slice."""
        if self._full_dirty:
            self._device = {name: torch.tensor(col, device=self.device)
                            for name, col in self._host_columns(0, self._capacity).items()}
            self._synced_rows = self._count
            self._full_dirty = False
            return
        lo, hi = self._synced_rows, self._count
        if lo >= hi:
            return
        # the copy is padded to a power-of-two row count (clamped to the
        # capacity), as the JAX package pads its splice; the padding rows
        # carry host truth, so writing them again changes nothing
        padded_hi = min(lo + self._query_bucket(hi - lo), self._capacity)
        for name, col in self._host_columns(lo, padded_hi).items():
            self._device[name][lo:padded_hi].copy_(torch.from_numpy(col))
        self._synced_rows = hi

    def query_points(self, query_vector: np.ndarray, *, limit: int, user_id: str | None = None,
                     date_gte: float | None = None) -> list[VectorPoint]:
        """Top-``limit`` cosine matches under the must-filters, best first.

        The serial host-mask path: the mask is built in numpy (from the
        code column, not the Python list), then one single-query scoring
        call. ``query_points_batch`` gives the same hits."""
        with self._lock:
            if self._count == 0:
                return []
            self._sync_device()
            mask = self._alive[: self._capacity].copy()
            mask[self._count:] = False
            if user_id is not None:
                code = self._user_interner.get(user_id, NO_MATCH_CODE)
                mask[: self._count] &= self._user_codes[: self._count] == code
            if date_gte is not None:
                mask[: self._count] &= self._dates[: self._count] >= date_gte
            if not mask.any():
                return []
            q = self._normalize(np.asarray(query_vector, np.float32))
            k = min(limit, self._capacity)
            scores, idx = score_topk(self._device["vectors"], self._upload(q[None]),
                                     self._upload(mask[None]), k)
            scores, idx = scores[0].cpu().numpy(), idx[0].cpu().numpy()
            out: list[VectorPoint] = []
            for s, i in zip(scores, idx):
                if not np.isfinite(s):
                    break
                out.append(self._points[int(i)])
            return out

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _query_bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def query_points_batch(self, queries: list[QuerySpec]) -> list[list[VectorPoint]]:
        """Top-k for B queries in one scoring call, the must-filter masks
        built on the device. The batch is padded to a power of two (padding
        queries match no row). Returns one best-first hit list per query,
        the same as ``query_points`` run serially."""
        if not queries:
            return []
        with self._lock:
            if self._count == 0:
                return [[] for _ in queries]
            self._sync_device()
            B = self._query_bucket(len(queries))
            q = np.zeros((B, self.dim), np.float32)
            q_codes = np.full((B,), NO_MATCH_CODE, np.int32)
            q_dates = np.full((B,), -np.inf, np.float64)
            limits = []
            for i, spec in enumerate(queries):
                q[i] = self._normalize(np.asarray(spec.vector, np.float32))
                if spec.user_id is None:
                    q_codes[i] = NO_FILTER_CODE
                else:
                    q_codes[i] = self._user_interner.get(spec.user_id, NO_MATCH_CODE)
                if spec.date_gte is not None:
                    q_dates[i] = spec.date_gte
                limits.append(min(int(spec.limit), self._capacity))
            k = max(limits)
            q_hi, q_lo = _split_f64(q_dates)
            dev = self._device
            mask = batch_mask(dev["alive"], dev["user_codes"], dev["dates_hi"], dev["dates_lo"],
                              *(self._upload(a) for a in (q_codes, q_hi, q_lo)))
            scores, idx = score_topk(dev["vectors"], self._upload(q), mask, k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
            results: list[list[VectorPoint]] = []
            for i in range(len(queries)):
                out: list[VectorPoint] = []
                for s, j in zip(scores[i, : limits[i]], idx[i, : limits[i]]):
                    if not np.isfinite(s):
                        break
                    out.append(self._points[int(j)])
                results.append(out)
            return results

    # --- durability -------------------------------------------------------
    # The reference's collection lives in a durable external Qdrant; the
    # on-device index persists to a local snapshot instead, so retrieval is
    # not empty at boot.

    def save(self, path: str) -> None:
        """Atomic snapshot: vectors as ``.npz``, payloads as a ``.jsonl``
        sidecar. ``_lock`` is held only to copy the arrays and payload refs
        (compression and file IO run outside it, so a snapshot never stalls
        queries or upserts); ``_save_lock`` serializes overlapping saves
        (a debounced ingest save racing the forced one at shutdown), which
        would otherwise interleave writes to the same ``.tmp`` files."""
        with self._save_lock:
            with self._lock:
                n = self._count
                vectors = self._host_vectors[:n].copy()
                dates = self._dates[:n].copy()
                alive = self._alive[:n].copy()
                points = list(self._points)
            base = Path(path)
            base.parent.mkdir(parents=True, exist_ok=True)
            # np.savez appends ".npz" unless the name already ends with it
            tmp_vec = str(base) + ".tmp.npz"
            np.savez_compressed(tmp_vec, vectors=vectors, dates=dates, alive=alive)
            tmp_pay = str(base) + ".jsonl.tmp"
            with open(tmp_pay, "w") as f:
                for p in points:
                    f.write(json.dumps({"id": p.id, "payload": p.payload}) + "\n")
            os.replace(tmp_vec, str(base) + ".npz")
            os.replace(tmp_pay, str(base) + ".jsonl")
        logger.info("vector index saved: %d points -> %s.{npz,jsonl}", n, path)

    @classmethod
    def load(cls, path: str, dim: int, device: torch.device | str = "cuda") -> "DeviceVectorIndex":
        """Restore a snapshot; a missing snapshot gives an empty index."""
        base = Path(path)
        vec_file, pay_file = Path(str(base) + ".npz"), Path(str(base) + ".jsonl")
        index = cls(dim=dim, device=device)
        if not (vec_file.exists() and pay_file.exists()):
            logger.info("no vector snapshot at %s; starting empty", path)
            return index
        data = np.load(vec_file)
        vectors, dates, alive = data["vectors"], data["dates"], data["alive"]
        with open(pay_file) as f:
            records = [json.loads(line) for line in f]
        if len(records) != len(vectors):
            # a crash between the two os.replace calls in save() can tear
            # the snapshot: a clear error, not an IndexError
            raise ValueError(
                f"snapshot mismatch at {path}: {len(vectors)} vectors vs "
                f"{len(records)} payloads (torn snapshot?)"
            )
        points = [
            VectorPoint(id=rec["id"], vector=vectors[row], payload=rec["payload"])
            for row, rec in enumerate(records)
        ]
        index.upsert(points)
        # the tombstones and the dates exactly as saved; the device columns
        # are stale after this direct mutation, so the next sync uploads all
        index._alive[: len(points)] = alive
        index._dates[: len(points)] = dates
        index._full_dirty = True
        logger.info("vector index restored: %d points from %s", len(points), path)
        return index
