"""Adaptive adversary policies: state-reactive Byzantine attacks.

A copy of ``hotstuff_tpu.faults.adaptive``, whole.  The base
:class:`~hotstuff_tpu_torch.faults.adversary.AdversaryPlane` fires
its policies on a seeded wall-clock schedule that cannot see what the
protocol is doing, so attacks that only bite in a specific protocol
state — a leader handoff, a snapshot bootstrap, an epoch boundary —
land by luck.  This module adds policies that *observe* a read-only,
deterministic **protocol-state view** and trigger exactly in the state
they were designed to exploit:

  ambush-leader    equivocate only in rounds where this node leads AND
                   the previous round ended in a TC (the committee is
                   already off-balance; a conflicting block there costs
                   the most)
  sync-predator    withhold exactly the state-sync CHUNKS a crash-
                   recovered peer is bootstrapping from us (manifests
                   are still served, so the victim commits to a sync it
                   cannot finish until the window closes)
  timeout-surfer   delay votes to just inside the observed view-timer
                   (backoff included), stretching every view to near
                   its timeout without ever firing a TC
  reconfig-sniper  forge reconfig ops and withhold votes only inside a
                   margin of rounds around an epoch activation boundary

State-view contract
-------------------
The view is a frozen façade over provider callbacks installed by
``Consensus.spawn`` (``AdversaryPlane.bind_view``).  It is READ-ONLY —
attribute assignment raises — and every provider is a pure read of
local protocol state (current round, leader schedule, last TC round,
view-timer duration, admission credit, peers mid-state-sync, epoch
boundaries, open incidents).  Trigger functions are pure predicates of
``(view, round)`` and consume **zero** rng draws, so the base plane's
fixed-draw determinism contract is untouched: the seeded decision
stream is byte-for-byte the same whether triggers fire or not.

Rng continuity across restarts
------------------------------
:class:`CountingRandom` counts primitive draws; when
``HOTSTUFF_ADAPT_RNG_DIR`` is set (the deterministic sim points it at
the run workdir) the plane checkpoints its rng state after every
recorded decision, and a crash-restarted adversary resumes the SAME
decision stream instead of replaying it from the top.
"""

from __future__ import annotations

import json
import logging
import os
import random

log = logging.getLogger(__name__)

#: the adaptive policy names accepted in adversary specs (rides in the
#: same ``adversary`` rule list as the base policies)
ADAPTIVE_POLICIES = (
    "ambush-leader",
    "sync-predator",
    "timeout-surfer",
    "reconfig-sniper",
)

#: policy -> short token used in counters (``byz_adapt_<token>``), log
#: lines (``byz adapt-<token> round N``, counted by the + BYZ block)
#: and journal edges (``byz.adapt.<token>``)
ADAPTIVE_SHORT = {
    "ambush-leader": "ambush",
    "sync-predator": "sync",
    "timeout-surfer": "surf",
    "reconfig-sniper": "snipe",
}


def surf_fraction() -> float:
    """timeout-surfer vote delay as a fraction of the observed view
    timer; clamped below 1.0 so the delayed vote always lands inside
    the timeout (the whole point is stalling WITHOUT firing a TC)."""
    frac = float(os.environ.get("HOTSTUFF_ADAPT_SURF_FRACTION", "0.55"))
    return max(0.0, min(0.95, frac))


def snipe_margin() -> int:
    """reconfig-sniper activation margin: the attack window spans
    ``boundary ± margin`` rounds around every epoch activation."""
    return int(os.environ.get("HOTSTUFF_ADAPT_SNIPE_MARGIN", "8"))


def flood_batch_cap() -> int:
    """Upper bound on one credit-capped flood producer batch (the
    effective batch is ``min(cap, victim's last advertised credit)``)."""
    return int(os.environ.get("HOTSTUFF_ADAPT_FLOOD_BATCH", "64"))


class StateView:
    """Read-only, deterministic view of the local protocol state.

    Built from provider callbacks (``AdversaryPlane.bind_view``); every
    accessor is a fresh pure read, so policies always see the current
    state without holding any mutable reference to it.  Mutation — of
    attributes or of the provider table — raises ``AttributeError``:
    an adaptive policy can observe the protocol, never steer it except
    through its declared attack seams.
    """

    __slots__ = ("_providers",)

    def __init__(self, providers: dict):
        object.__setattr__(self, "_providers", dict(providers))

    def __setattr__(self, name, value):
        raise AttributeError("StateView is read-only")

    def __delattr__(self, name):
        raise AttributeError("StateView is read-only")

    def _call(self, key: str, default=None):
        fn = self._providers.get(key)
        return default if fn is None else fn()

    @property
    def round(self) -> int:
        """The core's current consensus round."""
        return int(self._call("round", 0))

    def is_leader(self, round_: int) -> bool:
        """Does THIS node lead ``round_`` under the live schedule?"""
        leader = self._providers.get("leader")
        me = self._providers.get("self")
        if leader is None or me is None:
            return False
        return leader(int(round_)) == me()

    @property
    def last_tc_round(self) -> int | None:
        """The most recent round this node advanced past via a TC
        (None until the first TC advance)."""
        return self._call("last_tc_round")

    @property
    def timeout_ms(self) -> float:
        """The observed view-timer duration (backoff included)."""
        return float(self._call("timeout_ms", 0.0))

    @property
    def credit(self) -> int | None:
        """The local admission plane's last advertised credit window."""
        return self._call("credit")

    @property
    def syncing_peers(self) -> frozenset:
        """Peers that requested a state-sync manifest from this node
        (i.e. are mid-bootstrap against us)."""
        return frozenset(self._call("syncing", ()))

    @property
    def epoch_boundaries(self) -> tuple:
        """Rounds at which a non-initial epoch activates (empty for a
        static committee)."""
        return tuple(self._call("boundaries", ()))

    @property
    def incidents(self) -> int:
        """Open health-plane incidents observed locally."""
        return int(self._call("incidents", 0))


# ---------------------------------------------------------------------------
# trigger predicates — pure functions of (view, round), zero rng draws


def ambush_trigger(view: StateView, round_: int) -> bool:
    """Fire when this node leads ``round_`` and the PREVIOUS round was
    entered via a TC: ``_advance_round(r-1, via_tc=True)`` moves the
    committee to round r, so ``last_tc_round == round_ - 1`` means the
    view change that seated us as leader is still fresh."""
    last_tc = view.last_tc_round
    return (
        last_tc is not None
        and last_tc == round_ - 1
        and view.is_leader(round_)
    )


def sync_trigger(view: StateView, round_: int) -> bool:
    """Fire while at least one peer is mid-state-sync against us."""
    return bool(view.syncing_peers)


def surf_trigger(view: StateView, round_: int) -> bool:
    """Fire for votes routed to OTHER collectors: delaying a vote we
    would hand to ourselves stalls nobody but us."""
    return not view.is_leader(round_ + 1)


def snipe_trigger(view: StateView, round_: int) -> bool:
    """Fire within ``snipe_margin()`` rounds of any epoch activation
    boundary the live committee schedule declares."""
    margin = snipe_margin()
    return any(
        abs(int(round_) - int(b)) <= margin for b in view.epoch_boundaries
    )


#: policy -> (base actions it drives, trigger predicate).  The plane's
#: ``wants(action)`` consults this table after the schedule-driven
#: ``active(action)`` check: an adaptive rule whose window is open AND
#: whose trigger fires claims the action.
ADAPTIVE_TRIGGERS = {
    "ambush-leader": (("equivocate",), ambush_trigger),
    "sync-predator": (("sync-withhold",), sync_trigger),
    "timeout-surfer": (("vote-delay",), surf_trigger),
    "reconfig-sniper": (("reconfig", "withhold"), snipe_trigger),
}


# ---------------------------------------------------------------------------
# counted rng + restart continuity


class CountingRandom(random.Random):
    """``random.Random`` that counts primitive draws.

    Every composite method (``randrange``, ``sample``, ``uniform``,
    ...) funnels through ``random()`` or ``getrandbits()`` in CPython,
    so counting the two primitives counts every decision the adversary
    makes.  The count is what the restart-continuity checkpoint
    persists alongside the generator state."""

    def __init__(self, seedval=None):
        self.draws = 0
        super().__init__(seedval)

    def random(self):
        self.draws += 1
        return super().random()

    def getrandbits(self, k):
        self.draws += 1
        return super().getrandbits(k)


def rng_state_path(dir_: str, self_id: int) -> str:
    return os.path.join(dir_, f"adversary-rng-{int(self_id)}.json")


def save_rng_state(path: str, rng: CountingRandom) -> None:
    """Checkpoint the adversary's draw stream.  Atomic (write + rename)
    so a crash mid-save leaves the previous checkpoint intact."""
    version, internal, gauss = rng.getstate()
    doc = {
        "draws": rng.draws,
        "version": version,
        "internal": list(internal),
        "gauss": gauss,
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def load_rng_state(path: str, rng: CountingRandom) -> int | None:
    """Restore a checkpointed draw stream into ``rng``; returns the
    replayed draw count, or None when no checkpoint exists."""
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    rng.setstate((doc["version"], tuple(doc["internal"]), doc["gauss"]))
    rng.draws = int(doc["draws"])
    return rng.draws


__all__ = [
    "ADAPTIVE_POLICIES",
    "ADAPTIVE_SHORT",
    "ADAPTIVE_TRIGGERS",
    "CountingRandom",
    "StateView",
    "ambush_trigger",
    "flood_batch_cap",
    "load_rng_state",
    "rng_state_path",
    "save_rng_state",
    "snipe_margin",
    "snipe_trigger",
    "surf_fraction",
    "surf_trigger",
    "sync_trigger",
]
