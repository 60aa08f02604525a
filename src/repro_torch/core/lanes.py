"""Shared PD-fusion lane packer (DESIGN §6).

One implementation of the lane ordering + token-budget chunk packing used
by BOTH the real engine (`serving.engine.Engine`) and its discrete-event
twin (`serving.sim.ServingSimulator`), so the scheduling semantics cannot
drift between them. Pure functions over (lane, request) state — no cache
or clock dependencies.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple


def lane_order(pack: str, pairs: Iterable[Tuple]) -> List[Tuple]:
    """Packer policy ordering over (lane, request) pairs.

    'fifo' keeps the given (arrival/queue) order; 'srf' orders by shortest
    remaining prefill (rid tiebreak keeps it deterministic).
    """
    pairs = list(pairs)
    if pack == "srf":
        return sorted(pairs, key=lambda jr: (
            jr[1].prompt_len - jr[1].prefill_pos, jr[1].rid))
    return pairs


def _budget_order(pack: str, occupied: List[Tuple]) -> List[Tuple]:
    """Ordering for budget allocation across OCCUPIED lanes.

    fifo must mean arrival order, not lane-index order: with a tight
    budget, index order would let lane 0 — refilled with ever-newer
    arrivals — starve an older request parked in a higher lane forever.
    """
    if pack == "srf":
        return lane_order(pack, occupied)
    return sorted(occupied, key=lambda jr: (jr[1].arrival_time, jr[1].rid))


def pack_chunks(pack: str, lanes: Sequence[Optional[object]],
                budget_tokens: int,
                chunk_cap: int = 0) -> List[Tuple[int, object, int]]:
    """Split one interval's token budget across occupied lanes.

    One chunk per lane per interval, each exactly
    min(budget left, chunk_cap, remaining) tokens — exact-size tail chunks
    so stateful families never see pad tokens. chunk_cap = 0 means
    uncapped (a lane may take its whole remaining prompt; simulator-only).
    Returns [(lane, request, take)] in packing order.
    """
    plan: List[Tuple[int, object, int]] = []
    left = budget_tokens
    for j, r in _budget_order(pack, [(j, r) for j, r in enumerate(lanes)
                                     if r is not None]):
        if left <= 0:
            break
        cap = chunk_cap or (r.prompt_len - r.prefill_pos)
        take = min(left, cap, r.prompt_len - r.prefill_pos)
        if take <= 0:
            continue
        plan.append((j, r, take))
        left -= take
    return plan
