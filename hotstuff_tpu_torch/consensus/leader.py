"""Leader election.

Parity target: ``RRLeaderElector`` (reference consensus/src/leader.rs:5-21):
round-robin over the sorted committee public keys.  Epoch-aware: the
election asks ``for_round`` so a ``CommitteeSchedule`` rotates the
validator set at its boundaries; sorted key lists are cached per epoch
committee (the reference re-sorts per call; a committee is immutable
within an epoch).
"""

from __future__ import annotations

from ..crypto import PublicKey
from .config import Committee
from .messages import Round


class RoundRobinLeaderElector:
    def __init__(self, committee: Committee):
        self._committee = committee
        # id(com) -> (com, sorted keys).  The cache holds a STRONG
        # reference to each committee it has served, which is what makes
        # the id() key sound: a cached committee can never be collected,
        # so its id can never be reused by a different object (ADVICE r3
        # flagged the bare-id() variant's reliance on the schedule's own
        # lifetime for this).
        self._keys_cache: dict[int, tuple[Committee, list[PublicKey]]] = {}

    def get_leader(self, round_: Round) -> PublicKey:
        com = self._committee.for_round(round_)
        hit = self._keys_cache.get(id(com))
        if hit is None:
            hit = (com, com.sorted_keys())
            self._keys_cache[id(com)] = hit
        return hit[1][round_ % len(hit[1])]


LeaderElector = RoundRobinLeaderElector
