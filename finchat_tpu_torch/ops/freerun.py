"""Free-running loop staging: the descriptor queue and the token ring's
layout (the JAX package's ``ops/freerun.py``, kept as the port's own copy;
``engine.ragged_multi_round`` is the device program that drains it).

A captured run is ``F`` consecutive ragged rounds in one dispatch. The
device cannot ask the host anything mid-run, so everything the host
normally decides per round is PRE-STAGED here into ``[F, ...]`` descriptor
arrays, a queue the rounds drain in order:

- a prefilling prompt advances one chunk per round, deterministically, so
  its completion round is known at staging time; the completing round arms
  the row (its first token samples on the device) and every later round
  stages it as a device-read decode row: the pre-staged prompt is admitted
  on the device, with no host commit between;
- decode budgets (``max_new_tokens`` minus delivered minus the tokens
  still in flight in an unconsumed ring) are consumed deterministically
  too (1 a round, ``loop_depth`` when the fused tail rides), so a row past
  its budget stops appearing: the staged schedule IS the budget stop mask,
  and only EOS, the one data-dependent stop, is left to the device (the
  engine's ``row_live``);
- partial holds stage chunks up to their prefix end and never arm (they
  park, awaiting ``extend_prompt``); prefix-registration jobs stage chunks
  and never arm (no logits consumer).

The plan also fixes the RING layout the consumer reads back,
``ring_tokens[F, R]`` / ``ring_n[F, R]`` / ``ring_blocks[F, K-1, B]``,
indexed by the row order staged here, plus the ``row_arm`` matrix, the
exactly-once replay reference: a ring round may only deliver where the
staged plan armed; anything else is a free-run divergence.

Host numpy only (no device work, no syncs): staging runs on the
scheduler loop at dispatch time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RowSpec:
    """One engine slot riding a captured multi-round run."""

    slot: int
    kind: str  # "prefill" | "job" | "decode"
    ids: list | None = None  # prompt token ids (prefill/job rows)
    pos: int = 0  # prefill position at staging time
    # commit/emit tokens once the prompt completes (False: held overlap
    # holds and prefix jobs — they park instead of decoding)
    arm: bool = True
    # decode tokens the captured run may emit for this row (remaining
    # max_new_tokens minus tokens still undelivered in an in-flight ring)
    budget: int = 0
    loop_ok: bool = False  # may ride the fused loop_depth tail
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0


@dataclass
class FreerunPlan:
    """Staged descriptor queue for one captured run (device-ready arrays
    + the host bookkeeping the dispatch/consume seams need)."""

    rounds: int
    n_rows: int
    packed_tokens: int  # T before bucketing (the bucket fn padded it)
    tokens: np.ndarray  # [F, T]
    tok_row: np.ndarray  # [F, T]
    row_slot: np.ndarray  # [R]
    row_start: np.ndarray  # [F, R]
    row_len: np.ndarray  # [F, R]
    row_from_device: np.ndarray  # [F, R]
    row_arm: np.ndarray  # [F, R] — the exactly-once replay reference
    loop_active: np.ndarray  # [F, B] — staged fused-tail schedule
    temperature: np.ndarray  # [R]
    top_p: np.ndarray  # [R]
    top_k: np.ndarray  # [R]
    # every round has at least one staged row — an underfilled plan means
    # the work runs out mid-capture and the caller should fall back to
    # host-stepped rounds instead of burning empty device rounds
    active_rounds: int = 0
    # row index -> prompt tokens staged across the run (the dispatch-time
    # prefill_pos / job.pos advance, as in the host-stepped round)
    advanced: dict = field(default_factory=dict)
    # row index -> round where the prompt completes and the first token
    # arms (consume marks prefill_done and moves the handle to decoding)
    completes_at: dict = field(default_factory=dict)
    # slot -> max tokens this run can emit for it (the _undelivered /
    # budget-ahead accounting for the NEXT capture staged before this
    # ring is consumed)
    ahead: dict = field(default_factory=dict)


def stage_freerun(specs: list[RowSpec], *, rounds: int, chunk: int,
                  loop_depth: int, max_seqs: int, bucket) -> FreerunPlan:
    """Build the staged-descriptor queue for one captured run of
    ``rounds`` rounds. ``bucket`` maps a packed-token count to the warmed
    pow-2 bucket (engine.ragged_bucket) — every round pads to the same
    bucket, so the staged rounds stack into one [F, T] buffer. Rows are assigned in spec
    order (ascending contiguous packing, the ragged step's invariant)."""
    F = rounds
    R = max_seqs
    n = len(specs)
    assert n <= R, f"{n} rows > {R} slots"
    K = max(1, loop_depth)

    row_slot = np.zeros((R,), np.int32)
    row_start = np.zeros((F, R), np.int32)
    row_len = np.zeros((F, R), np.int32)
    row_from_device = np.zeros((F, R), bool)
    row_arm = np.zeros((F, R), bool)
    loop_active = np.zeros((F, max_seqs), bool)
    temperature = np.zeros((R,), np.float32)
    top_p = np.ones((R,), np.float32)
    top_k = np.zeros((R,), np.int32)
    plan = FreerunPlan(
        rounds=F, n_rows=n, packed_tokens=0,
        tokens=np.zeros((F, 0), np.int32), tok_row=np.zeros((F, 0), np.int32),
        row_slot=row_slot, row_start=row_start, row_len=row_len,
        row_from_device=row_from_device, row_arm=row_arm,
        loop_active=loop_active,
        temperature=temperature, top_p=top_p, top_k=top_k,
    )

    pos = [s.pos for s in specs]  # prompt cursor (prefill/job rows)
    emitted = [0] * n  # staged-emission cursor (the budget stop)
    decoding = [s.kind == "decode" for s in specs]
    per_round: list[list[tuple[int, list[int]]]] = []  # (row, tokens)

    for i, s in enumerate(specs):
        row_slot[i] = s.slot
        temperature[i] = s.temperature
        top_p[i] = s.top_p
        top_k[i] = s.top_k

    for r in range(F):
        staged: list[tuple[int, list[int]]] = []
        for i, s in enumerate(specs):
            if not decoding[i]:
                if s.ids is not None and pos[i] < len(s.ids):
                    seg = list(s.ids[pos[i] : pos[i] + chunk])
                    row_start[r, i] = pos[i]
                    row_len[r, i] = len(seg)
                    staged.append((i, seg))
                    pos[i] += len(seg)
                    if s.kind == "prefill" and s.arm and pos[i] >= len(s.ids):
                        # prompt completes this round: arm it (the first
                        # token samples on-device with the row's params)
                        # and decode from the next round on
                        row_arm[r, i] = True
                        plan.completes_at[i] = r
                        emitted[i] = 1
                        decoding[i] = True
                # exhausted non-arming rows (jobs, held holds) park:
                # no further rounds staged
                continue
            rem = s.budget - emitted[i]
            if rem < 1:
                continue  # budget exhausted: staged away (the host evicts
                # the stream at drain time, exactly the round-stepped path)
            row_len[r, i] = 1
            row_from_device[r, i] = True
            row_arm[r, i] = True
            staged.append((i, [0]))  # token 0 reads last_tokens ON DEVICE
            if s.loop_ok and K > 1 and rem >= K:
                loop_active[r, s.slot] = True
                emitted[i] += K
            else:
                emitted[i] += 1
        per_round.append(staged)

    plan.active_rounds = sum(1 for staged in per_round if staged)
    for i, s in enumerate(specs):
        if s.kind in ("prefill", "job"):
            plan.advanced[i] = pos[i] - s.pos
        if emitted[i]:
            plan.ahead[s.slot] = emitted[i]

    plan.packed_tokens = max(
        (sum(len(toks) for _i, toks in staged) for staged in per_round),
        default=0,
    )
    T = bucket(max(1, plan.packed_tokens))
    tokens = np.zeros((F, T), np.int32)
    tok_row = np.full((F, T), R, np.int32)  # R = buffer padding
    for r, staged in enumerate(per_round):
        off = 0
        for i, toks in staged:
            tokens[r, off : off + len(toks)] = toks
            tok_row[r, off : off + len(toks)] = i
            off += len(toks)
    plan.tokens = tokens
    plan.tok_row = tok_row
    return plan
