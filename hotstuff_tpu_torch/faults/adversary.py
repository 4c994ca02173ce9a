"""AdversaryPlane: seeded, deterministic Byzantine behavior injection.

A copy of ``hotstuff_tpu.faults.adversary``, whole.  Where
:class:`~hotstuff_tpu_torch.faults.plane.FaultPlane` attacks the
*network* (omission faults: drop/delay/duplicate/corrupt), the
adversary plane attacks the *protocol*: a node selected by the spec
runs one or more attack policies on the same seeded scenario schedule.
Attacks are injected at the proposer/core/aggregator seams — NOT the
wire layer — so every adversarial message is a well-formed frame that
exercises the committee's real verification paths.

Policies
  equivocate   as leader, sign and ship a second conflicting block for
               the same round to a subset of peers
  forge-qc     broadcast properly-signed timeouts whose high_qc names
               real committee authors but carries garbage aggregate
               signatures (hits ``_preverify_burst`` / QC verification
               on honest nodes, which must reject)
  withhold     receive proposals but never vote, forcing the committee
               through timeout quorums (liveness pressure; must heal)
  double-vote  vote for the leader's block AND a fabricated conflicting
               digest in the same round (hits the aggregator's
               second-cell parking on the honest next leader)
  flood        sustained bursts of garbage votes / spoofed votes /
               garbage timeouts (the reusable form of the ad-hoc burst
               loop from tests/test_byzantine_e2e.py)
  collude      f+1 coordinated equivocators: colluders equivocate when
               leading, double-vote the shadow branch, and the
               designated shadow committer reports the shadow chain in
               its commit log — producing a REAL divergent history the
               safety checker must catch and attribute
  reconfig     attack the reconfiguration plane from both ends: as
               leader, attach a FORGED epoch change (attacker-only
               committee, garbage sponsor signature) that must die in
               every honest voter's Block.verify; and report epoch
               activations at skewed rounds — a divergent epoch
               history the epoch-agreement invariant must catch

Determinism contract (same bar as the fault plane): every random
choice is drawn from a per-node ``random.Random`` seeded from
``(scenario seed, node index)`` — str seeding hashes through SHA-512,
so the stream is identical across processes and runs regardless of
PYTHONHASHSEED.  Each decision consumes a FIXED number of draws;
wall-clock gates only which policy windows are active, never the draw
stream.  Shadow payloads are a pure function of (seed, round) so
colluders agree on the shadow branch without communicating.

Spec: the adversary rides in the same JSON spec as the fault plane
(``HOTSTUFF_ADVERSARY`` accepts an inline object or a file path, and
the chaos runner points it at the same ``.faults.json``)::

    {"seed": 0, "name": "byz-equivocate",
     "nodes": {"host:port": index, ...}, "epoch_unix": ...,
     "adversary": [
        {"policy": "equivocate", "node": 0, "at": 2.0, "until": null}
     ]}
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os

from ..utils.clock import default_clock
from .adaptive import (
    ADAPTIVE_POLICIES,
    ADAPTIVE_SHORT,
    ADAPTIVE_TRIGGERS,
    CountingRandom,
    StateView,
    flood_batch_cap,
    load_rng_state,
    rng_state_path,
    save_rng_state,
    surf_fraction,
)
from .plane import _addr_key

log = logging.getLogger(__name__)

POLICIES = (
    "equivocate",
    "forge-qc",
    "withhold",
    "double-vote",
    "flood",
    "collude",
    "reconfig",
) + ADAPTIVE_POLICIES

#: flood policy burst cadence (seconds between bursts)
FLOOD_BURST_S = 0.025


class AdversaryRule:
    """One policy window over a set of adversarial node indexes."""

    __slots__ = ("policy", "nodes", "at", "until", "rate", "label")

    def __init__(self, policy: str, nodes, at: float = 0.0,
                 until: float | None = None, rate: float = 1.0,
                 label: str | None = None):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown adversary policy {policy!r}; "
                f"choose from {sorted(POLICIES)}"
            )
        self.policy = policy
        if isinstance(nodes, int):
            nodes = (nodes,)
        self.nodes = frozenset(int(v) for v in nodes)
        self.at = float(at)
        self.until = None if until is None else float(until)
        self.rate = float(rate)
        self.label = label or policy

    def active(self, t: float) -> bool:
        if t < self.at:
            return False
        return self.until is None or t < self.until


def expand_adversary(spec: dict) -> list[AdversaryRule]:
    """Parse the spec's ``adversary`` list into rules."""
    rules = []
    for raw in spec.get("adversary", ()):
        rules.append(
            AdversaryRule(
                raw["policy"],
                raw.get("node", raw.get("nodes", ())),
                at=raw.get("at", 0.0),
                until=raw.get("until"),
                rate=raw.get("rate", 1.0),
                label=raw.get("label"),
            )
        )
    return rules


class AdversaryPlane:
    """One node's view of the Byzantine scenario.

    Constructed on every node (the spec is shared); inert — every
    ``active()`` query returns False — unless the spec names this
    node's index in at least one policy rule.  The consensus stack
    consults it at the attack seams; the plane owns the RNG, counters,
    journal edges, and the deterministic shadow-branch math.
    """

    def __init__(self, spec: dict, self_address, now: float | None = None):
        self.spec = spec
        self.seed = int(spec.get("seed", 0))
        self.name = spec.get("name", "custom")
        self.nodes: dict[str, int] = {
            k: int(v) for k, v in spec.get("nodes", {}).items()
        }
        self.self_id = self.nodes.get(_addr_key(self_address))
        self.rules = expand_adversary(spec)
        self.my_rules = [
            r for r in self.rules
            if self.self_id is not None and self.self_id in r.nodes
        ]
        clock = default_clock()
        wall0 = clock.time()
        mono0 = clock.monotonic()
        boot = wall0 if now is None else now
        epoch = spec.get("epoch_unix")
        self.epoch = float(epoch) if epoch is not None else boot
        if self.epoch < boot - 3600.0:
            log.warning(
                "adversary spec epoch is stale (%.0fs old); using boot time",
                boot - self.epoch,
            )
            self.epoch = boot
        # monotonic anchor: window arithmetic survives NTP steps
        # (same scheme as FaultPlane — see faults/plane.py)
        self._mono_epoch = mono0 - (wall0 - self.epoch)
        self.rng = CountingRandom(f"{self.seed}|adversary|{self.self_id}")
        self.counts = {
            "byz_equivocations": 0,
            "byz_forged_qcs": 0,
            "byz_votes_withheld": 0,
            "byz_double_votes": 0,
            "byz_floods": 0,
            "byz_shadow_commits": 0,
            "byz_forged_reconfigs": 0,
            "byz_shadow_epochs": 0,
            "byz_flood_accepted": 0,
            "byz_flood_shed": 0,
            "byz_adapt_ambush": 0,
            "byz_adapt_sync": 0,
            "byz_adapt_surf": 0,
            "byz_adapt_snipe": 0,
        }
        #: adaptive plane (faults/adaptive.py): the read-only protocol-
        #: state view, installed by Consensus.spawn via bind_view();
        #: None until then (wants() degrades to active())
        self.view: StateView | None = None
        #: peers mid-state-sync against this node (sync-predator prey),
        #: fed by the StateSyncServer's note_syncing hook
        self._syncing: set = set()
        #: credit window last advertised by the flood target's ingest
        #: ACK (None until the first ACK); caps the next flood batch
        self.flood_credit: int | None = None
        # Restart continuity: when the harness points
        # HOTSTUFF_ADAPT_RNG_DIR at the run workdir, the draw stream is
        # checkpointed after every recorded decision and a
        # crash-restarted adversary resumes it instead of replaying
        # from the top.
        self._rng_path = None
        rng_dir = os.environ.get("HOTSTUFF_ADAPT_RNG_DIR")
        if rng_dir and self.self_id is not None:
            os.makedirs(rng_dir, exist_ok=True)
            self._rng_path = rng_state_path(rng_dir, self.self_id)
            restored = load_rng_state(self._rng_path, self.rng)
            if restored is not None:
                log.info(
                    "adversary rng restored: resuming the decision "
                    "stream at draw %d", restored,
                )
        #: colluding node indexes, sorted (collude rules only)
        self.colluders = sorted(
            frozenset().union(
                *(r.nodes for r in self.rules if r.policy == "collude")
            ) if any(r.policy == "collude" for r in self.rules)
            else frozenset()
        )
        #: authority names of colluders, resolved by bind()
        self.colluder_names: set = set()
        self.names_by_index: dict[int, object] = {}
        self.journal = None  # set by Consensus.spawn when journaling

    @classmethod
    def load(cls, spec_or_path: str, self_address, now: float | None = None):
        """Build a plane from an inline JSON object or a spec file path
        (the ``HOTSTUFF_ADVERSARY`` knob accepts both)."""
        text = spec_or_path.strip()
        if text.startswith("{"):
            spec = json.loads(text)
        else:
            with open(spec_or_path) as f:
                spec = json.load(f)
        return cls(spec, self_address, now=now)

    # ------------------------------------------------------------------
    # selection / scheduling

    @property
    def enabled(self) -> bool:
        """True when the spec names this node in any policy rule."""
        return bool(self.my_rules)

    def _t(self, now: float | None = None) -> float:
        if now is None:
            return default_clock().monotonic() - self._mono_epoch
        return now - self.epoch

    def active(self, policy: str, now: float | None = None) -> bool:
        """Is ``policy`` live on THIS node at ``now``?  The collude
        policy implies equivocate and double-vote (colluders run the
        full attack suite while the window is open)."""
        if not self.my_rules:
            return False
        t = self._t(now)
        for r in self.my_rules:
            if not r.active(t):
                continue
            if r.policy == policy:
                return True
            if r.policy == "collude" and policy in (
                "equivocate", "double-vote",
            ):
                return True
        return False

    # ------------------------------------------------------------------
    # adaptive plane (faults/adaptive.py)

    def bind_view(self, providers: dict) -> None:
        """Install the read-only protocol-state view the adaptive
        triggers observe.  Called by Consensus.spawn once the core is
        built; provider callbacks are pure reads of local state
        (round, leader schedule, timer, admission credit, ...).  Takes
        a dict (not kwargs) because ``self`` is a provider key."""
        base = {
            "syncing": lambda s=self._syncing: frozenset(s),
            "incidents": lambda: 0,
        }
        base.update(providers)
        self.view = StateView(base)

    def note_syncing(self, peer) -> None:
        """Protocol hook (StateSyncServer): ``peer`` requested a
        manifest, i.e. began a snapshot bootstrap against this node.
        Entries persist for the process lifetime — sync-predator stalks
        the peer for as long as its policy window stays open; once the
        window closes the chunks flow and the bootstrap completes."""
        self._syncing.add(peer)

    def wants(self, action: str, round_: int | None = None,
              now: float | None = None):
        """Does any live policy want ``action`` in ``round_``?

        Returns ``True`` when a schedule-driven policy window covers
        the action (exactly ``active()``), the adaptive short token —
        a truthy str the seams pass to :meth:`mark_adaptive` — when a
        state-reactive trigger fires, and ``False`` otherwise.
        Trigger evaluation is a pure read of the state view: ZERO rng
        draws, so the fixed-draw determinism contract is untouched.
        """
        if self.active(action, now):
            return True
        if self.view is None or not self.my_rules:
            return False
        t = self._t(now)
        r = self.view.round if round_ is None else int(round_)
        for rule in self.my_rules:
            trig = ADAPTIVE_TRIGGERS.get(rule.policy)
            if trig is None or not rule.active(t):
                continue
            actions, fire = trig
            if action in actions and fire(self.view, r):
                return ADAPTIVE_SHORT[rule.policy]
        return False

    def mark_adaptive(self, fired, round_: int = 0, logger=None,
                      digest=None) -> None:
        """Attribute an adaptive trigger firing: ``fired`` is the token
        :meth:`wants` returned.  Bumps the per-policy counter, journals
        the ``byz.adapt.<token>`` edge and emits the attack log line
        the ``+ BYZ`` activity regex counts.  A non-str ``fired`` (a
        plain schedule-driven True) is a no-op."""
        if not isinstance(fired, str):
            return
        self.count(f"byz_adapt_{fired}")
        self.record(f"adapt.{fired}", round_, digest)
        (logger or log).info("byz adapt-%s round %d", fired, round_)

    def surf_delay_s(self, timeout_s: float) -> float:
        """timeout-surfer vote delay: a fixed fraction of the OBSERVED
        view timer (backoff included), strictly inside the timeout."""
        return surf_fraction() * float(timeout_s)

    def _save_rng(self) -> None:
        if self._rng_path is not None:
            save_rng_state(self._rng_path, self.rng)

    def bind(self, committee, self_name) -> None:
        """Resolve node indexes to authority names against the live
        committee (the spec only knows addresses)."""
        pairs = list(committee.broadcast_addresses(self_name))
        pairs.append((self_name, committee.address(self_name)))
        for nm, addr in pairs:
            if addr is None:
                continue
            idx = self.nodes.get(_addr_key(addr))
            if idx is not None:
                self.names_by_index[idx] = nm
        self.colluder_names = {
            self.names_by_index[i]
            for i in self.colluders
            if i in self.names_by_index
        }

    @property
    def is_shadow_committer(self) -> bool:
        """The highest-indexed colluder reports the shadow chain in its
        commit log (one divergent history is enough for the checker;
        deterministic designation needs no coordination)."""
        return bool(self.colluders) and self.self_id == self.colluders[-1]

    # ------------------------------------------------------------------
    # attack math (shared by the attacking seams)

    def shadow_payloads(self, round_: int) -> tuple:
        """The shadow branch's payload for ``round_`` — a pure function
        of (seed, round) so every colluder derives the same conflicting
        block without communicating."""
        from ..crypto import Digest

        return (Digest.of(f"byz-shadow|{self.seed}|{round_}".encode()),)

    def shadow_block(self, block):
        """The conflicting twin of ``block``: same author/round/qc/tc,
        shadow payloads.  Unsigned — the equivocator signs its own copy;
        observers only need the digest (signatures are not part of it)."""
        from ..consensus.messages import Block

        return Block(
            qc=block.qc,
            tc=block.tc,
            author=block.author,
            round=block.round,
            payloads=self.shadow_payloads(block.round),
        )

    def equivocation_targets(self, names_addresses):
        """The deterministic peer subset that receives the shadow block:
        fellow colluders when colluding (the honest committee keeps
        committing the main branch), otherwise the lexicographically
        first half of the peer set."""
        pairs = sorted(names_addresses, key=lambda p: str(p[0]))
        if self.colluder_names:
            return [p for p in pairs if p[0] in self.colluder_names]
        return pairs[: max(1, len(pairs) // 2)]

    def forged_qc(self, committee, round_: int):
        """A structurally valid QC — real committee authors, quorum-many
        entries, passes ``check_weight`` — whose signatures are seeded
        garbage, so honest verification MUST reject it.  Consumes 64
        draws per signature (fixed per call for a given committee)."""
        from ..consensus.messages import QC
        from ..crypto import Digest, Signature

        authors = sorted(
            (nm for nm, _ in committee.broadcast_addresses(None)),
            key=str,
        )
        need = committee.quorum_threshold()
        votes = [
            (nm, Signature(bytes(self.rng.getrandbits(8) for _ in range(64))))
            for nm in authors[:need]
        ]
        return QC(
            hash=Digest.of(f"byz-forged|{self.seed}|{round_}".encode()),
            round=round_,
            votes=votes,
        )

    def forged_compact_qc(self, committee, round_: int):
        """The compact-form twin of ``forged_qc``: a quorum-popcount
        signer bitmap over the committee's sorted key order plus a
        seeded garbage 48-byte aggregate signature.  Passes decode and
        ``check_weight``; aggregate verification (one pairing) MUST
        reject it.  Consumes 48 draws (fixed per call)."""
        from ..consensus.messages import QC, make_signer_bitmap
        from ..crypto import Digest, Signature

        ordered = committee.sorted_keys()
        need = committee.quorum_threshold()
        bitmap = make_signer_bitmap(ordered[:need], ordered)
        return QC(
            hash=Digest.of(f"byz-forged|{self.seed}|{round_}".encode()),
            round=round_,
            votes=[],
            agg_sig=Signature(
                bytes(self.rng.getrandbits(8) for _ in range(48))
            ),
            signers=bitmap,
        )

    def forged_reconfig(self, committee, round_: int):
        """A well-formed (wire-decodable) reconfiguration op whose
        committee is entirely attacker keys and whose sponsor signature
        is seeded garbage — it passes decode and rides in this leader's
        block, and MUST die in every honest voter's ``Block.verify``
        (the continuity rule: attacker-only members carry zero stake
        from the current epoch).  One seeded draw gates each leader
        slot; 64 further draws build the garbage signature."""
        if self.rng.random() >= 0.5:
            return None
        from ..consensus.config import Authority, Committee
        from ..consensus.reconfig import ReconfigOp, newest_epoch
        from ..crypto import Signature, generate_keypair

        seed32 = hashlib.sha512(
            f"byz-reconfig|{self.seed}".encode()
        ).digest()[:32]
        cur = committee.for_round(round_)
        authorities = {}
        for i in range(max(1, len(cur.authorities))):
            pk, _ = generate_keypair(seed32, i)
            authorities[pk] = Authority(1, ("203.0.113.1", 7000 + i))
        hostile = Committee(
            authorities=authorities,
            epoch=newest_epoch(committee) + 1,
            scheme="ed25519",
        )
        return ReconfigOp(
            new_committee=hostile,
            margin=4,
            sponsor=next(iter(authorities)),
            signature=Signature(
                bytes(self.rng.getrandbits(8) for _ in range(64))
            ),
        )

    # ------------------------------------------------------------------
    # accounting

    def count(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n
        # decision boundary: checkpoint the draw stream so a restarted
        # adversary resumes rather than replays it (faults/adaptive.py)
        self._save_rng()

    def record(self, event: str, round_: int = 0, digest=None,
               peer: str = "") -> None:
        """Journal a ``byz.*`` edge (rendered as the adversary track by
        a trace viewer)."""
        if self.journal is not None:
            self.journal.record(f"byz.{event}", round_, digest, peer)
        self._save_rng()

    def describe(self) -> str:
        mine = ",".join(sorted({r.policy for r in self.my_rules})) or "none"
        return (
            f"scenario {self.name!r} seed {self.seed} "
            f"(node index {self.self_id}, policies [{mine}])"
        )

    def window_edges(self) -> list[tuple[float, str, str]]:
        """THIS node's policy window edges as (t_rel, "open"|"close",
        policy label), sorted — the adversary clock task walks this."""
        edges: set[tuple[float, str, str]] = set()
        for rule in self.my_rules:
            edges.add((rule.at, "open", rule.label))
            if rule.until is not None:
                edges.add((rule.until, "close", rule.label))
        order = {"close": 0, "open": 1}
        return sorted(edges, key=lambda e: (e[0], order[e[1]], e[2]))

    def stats(self) -> dict:
        """Telemetry snapshot section."""
        return {
            "scenario": self.name,
            "seed": self.seed,
            "node": self.self_id,
            "policies": sorted({r.policy for r in self.my_rules}),
            **self.counts,
        }


async def run_adversary_clock(plane: AdversaryPlane, journal=None) -> None:
    """Walk the adversary's policy window edges in real time, logging
    each and journaling ``byz.open`` / ``byz.close`` records so traces
    render an adversary track.  Spawned by Consensus.spawn on attacking
    nodes; cancelled at shutdown."""
    for t_rel, kind, label in plane.window_edges():
        delay = (plane._mono_epoch + t_rel) - default_clock().monotonic()
        if delay > 0:
            await default_clock().sleep(delay)
        log.info("Adversary window %s: %s (t=%.1fs)", kind, label, t_rel)
        if journal is not None:
            journal.record(f"byz.{kind}", 0, None, label)


async def run_flood(plane: AdversaryPlane, committee, name,
                    signature_service=None) -> None:
    """The flood policy: sustained bursts of garbage votes, spoofed
    votes naming honest authorities, and garbage timeouts — every frame
    well-formed at the wire layer, every signature invalid, so honest
    nodes burn real verification work rejecting them.  The reusable
    form of the reference tests' ad-hoc burst loop."""
    from ..consensus.errors import SerializationError
    from ..consensus.messages import QC, Timeout, Vote
    from ..consensus.wire import (
        decode_ingest_ack,
        encode_producer_batch,
        encode_timeout,
        encode_vote,
    )
    from ..crypto import Digest, Signature
    from ..network import SimpleSender
    from ..network.framing import read_frame, send_frame
    from ..utils.clock import default_connector

    sender = SimpleSender()
    peers = [
        (nm, addr) for nm, addr in committee.broadcast_addresses(name)
    ]
    honest = [nm for nm, _ in peers]
    rng = plane.rng
    # Credit-capped ingest flood: alongside the garbage-signature
    # bursts, hammer ONE deterministic victim's producer port with content-addressed garbage payloads — but never
    # more per batch than the victim's last advertised admission credit
    # window.  The attack exercises the shed path (typed BUSY ACKs)
    # instead of growing the proposer buffer without bound, and the ACK
    # stream gives the + BYZ block its accepted-vs-shed accounting.
    target = min(peers, key=lambda p: str(p[0])) if peers else None
    ingest_conn = None

    async def ingest_flood(rnd: int) -> None:
        nonlocal ingest_conn
        if target is None:
            return
        cap = flood_batch_cap()
        credit = plane.flood_credit
        n = cap if credit is None else max(1, min(cap, credit))
        items = []
        for k in range(n):
            # pure function of (seed, round, k): zero rng draws, and the
            # body hashes to its digest so content addressing admits it
            # and the payload really consumes admission credit
            body = f"byz-flood|{plane.seed}|{rnd}|{k}".encode()
            items.append((Digest.of(body), body))
        frame = encode_producer_batch(items)
        try:
            if ingest_conn is None:
                ingest_conn = await default_connector()(*target[1])
            reader, writer = ingest_conn
            await send_frame(writer, frame)
            ack = decode_ingest_ack(
                await asyncio.wait_for(read_frame(reader), 1.0)
            )
        except (
            ConnectionError,
            OSError,
            asyncio.TimeoutError,
            asyncio.IncompleteReadError,
            SerializationError,
        ):
            conn, ingest_conn = ingest_conn, None
            if conn is not None:
                try:
                    conn[1].close()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    pass
            return
        if ack is None:
            return  # legacy v1 Ack: no admission decision to read
        plane.flood_credit = ack.credit
        plane.count("byz_flood_accepted", ack.accepted)
        plane.count("byz_flood_shed", ack.shed)
        plane.record(
            "flood-admission", rnd, None, f"a{ack.accepted}/s{ack.shed}"
        )
        log.info(
            "byz flood admission: accepted %d shed %d credit %d",
            ack.accepted, ack.shed, ack.credit,
        )

    try:
        while True:
            await default_clock().sleep(FLOOD_BURST_S)
            if not plane.active("flood"):
                continue
            rnd = rng.randrange(1, 1 << 20)
            frames = []
            # (a) garbage votes under our own identity
            for _ in range(3):
                frames.append(encode_vote(Vote(
                    hash=Digest.of(bytes(
                        rng.getrandbits(8) for _ in range(16))),
                    round=rnd,
                    author=name,
                    signature=Signature(bytes(
                        rng.getrandbits(8) for _ in range(64))),
                )))
            # (b) spoofed votes naming honest authorities
            for victim in honest[:2]:
                frames.append(encode_vote(Vote(
                    hash=Digest.of(f"byz-spoof|{rnd}".encode()),
                    round=rnd,
                    author=victim,
                    signature=Signature(bytes(
                        rng.getrandbits(8) for _ in range(64))),
                )))
            # (c) a garbage timeout anchored at the genesis QC
            frames.append(encode_timeout(Timeout(
                high_qc=QC.genesis(),
                round=rnd,
                author=name,
                signature=Signature(bytes(
                    rng.getrandbits(8) for _ in range(64))),
            )))
            for _, addr in peers:
                for frame in frames:
                    await sender.send(addr, frame)
            await ingest_flood(rnd)
            plane.count("byz_floods")
            plane.record("flood", rnd, None, f"{len(frames)}x{len(peers)}")
            log.info(
                "byz flood burst: %d frames to %d peers (round %d)",
                len(frames), len(peers), rnd,
            )
    except asyncio.CancelledError:
        raise
    finally:
        if ingest_conn is not None:
            try:
                ingest_conn[1].close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        close = getattr(sender, "close", None)
        if close is not None:
            try:
                res = close()
                if asyncio.iscoroutine(res):
                    await res
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass


__all__ = [
    "POLICIES",
    "AdversaryPlane",
    "AdversaryRule",
    "expand_adversary",
    "run_adversary_clock",
    "run_flood",
]
