"""WAN link-delay emulation for co-located committees.

A copy of ``hotstuff_tpu.network.wan``.  The reference's baseline
numbers are 5-region AWS WAN runs, while a committee on one host sees
sub-millisecond round trips.  This module injects per-link propagation
delay and jitter at the SENDER layer so a localhost committee
experiences the reference's topology:

- a spec file maps each committee address to a region and carries a
  symmetric ONE-WAY delay matrix between regions (defaults model the
  reference's us-east-1 / eu-north-1 / ap-southeast-2 / us-west-1 /
  ap-northeast-1 spread);
- senders delay each outbound message independently (deliver-at
  scheduling, FIFO-clamped per link — pipelined like real propagation,
  never head-of-line rate-limited);
- the reliable sender also delays ACK future *resolution* by the return
  leg, so the proposer's 2f+1-ACK back-pressure sees full RTTs.

``HOTSTUFF_WAN_SPEC=<spec file>`` turns it on in ``Consensus.spawn`` on
the asyncio transport (the native reactor does its own I/O and is never
delayed).  A spec for a committee's addresses::

    json.dump(build_spec(addresses), open("wan.json", "w"))

Modelling limits: bandwidth is not modelled (consensus messages are
KB-scale, latency-bound); receiver-side ACK writes to SimpleSender
peers are not delayed (those ACKs are sunk unread); a client
co-located with its nodes keeps fast client->node links (it is not in
the spec).
"""

from __future__ import annotations

import asyncio
import json

from ..utils.clock import default_clock, default_rng

Address = tuple[str, int]

# Default one-way delays (ms) between the reference's five regions,
# derived from typical inter-region RTTs (RTT/2).  Intra-region ~0.5 ms.
DEFAULT_REGIONS = (
    "us-east-1",
    "eu-north-1",
    "ap-southeast-2",
    "us-west-1",
    "ap-northeast-1",
)
DEFAULT_MATRIX = {
    ("us-east-1", "eu-north-1"): 55.0,
    ("us-east-1", "ap-southeast-2"): 100.0,
    ("us-east-1", "us-west-1"): 30.0,
    ("us-east-1", "ap-northeast-1"): 75.0,
    ("eu-north-1", "ap-southeast-2"): 140.0,
    ("eu-north-1", "us-west-1"): 80.0,
    ("eu-north-1", "ap-northeast-1"): 120.0,
    ("ap-southeast-2", "us-west-1"): 70.0,
    ("ap-southeast-2", "ap-northeast-1"): 55.0,
    ("us-west-1", "ap-northeast-1"): 50.0,
}
INTRA_REGION_MS = 0.5
DEFAULT_JITTER_PCT = 10.0


def _addr_key(address: Address) -> str:
    return f"{address[0]}:{address[1]}"


def build_spec(addresses: list[Address]) -> dict:
    """A spec assigning committee addresses round-robin over the five
    default regions (the reference runs one node per instance spread
    over its regions the same way)."""
    regions = {
        _addr_key(a): DEFAULT_REGIONS[i % len(DEFAULT_REGIONS)]
        for i, a in enumerate(addresses)
    }
    matrix = {
        f"{a}|{b}": ms for (a, b), ms in DEFAULT_MATRIX.items()
    }
    return {
        "regions": regions,
        "matrix_one_way_ms": matrix,
        "intra_region_ms": INTRA_REGION_MS,
        "jitter_pct": DEFAULT_JITTER_PCT,
    }


class WanModel:
    """Per-link one-way delay sampling from a spec."""

    def __init__(self, spec: dict, self_address: Address):
        self.regions: dict[str, str] = spec["regions"]
        self.matrix: dict[tuple[str, str], float] = {}
        for key, ms in spec["matrix_one_way_ms"].items():
            a, b = key.split("|")
            self.matrix[(a, b)] = float(ms)
            self.matrix[(b, a)] = float(ms)
        self.intra_ms = float(spec.get("intra_region_ms", INTRA_REGION_MS))
        self.jitter_pct = float(spec.get("jitter_pct", DEFAULT_JITTER_PCT))
        self.self_region = self.regions.get(_addr_key(self_address))

    @classmethod
    def load(cls, path: str, self_address: Address) -> "WanModel":
        with open(path) as f:
            return cls(json.load(f), self_address)

    def delay(self, dst: Address) -> float:
        """Sampled one-way delay (seconds) from this node to ``dst``.
        Unknown peers (not in the spec — e.g. a client) get zero."""
        dst_region = self.regions.get(_addr_key(dst))
        if self.self_region is None or dst_region is None:
            return 0.0
        base = (
            self.intra_ms
            if dst_region == self.self_region
            else self.matrix.get((self.self_region, dst_region), self.intra_ms)
        )
        jitter = default_rng().gauss(0.0, base * self.jitter_pct / 100.0)
        return max(0.0, (base + jitter) / 1e3)


class LinkScheduler:
    """Deliver-at scheduling for one link: each message is delayed
    independently (pipelined), with FIFO clamping so jitter can never
    reorder frames on the TCP stream."""

    __slots__ = ("_delay_fn", "_last_at")

    def __init__(self, delay_fn):
        self._delay_fn = delay_fn
        self._last_at = 0.0

    def deliver_at(self) -> float:
        loop = asyncio.get_running_loop()
        at = loop.time() + self._delay_fn()
        self._last_at = at = max(at, self._last_at)
        return at

    @staticmethod
    async def wait_until(at: float) -> None:
        remaining = at - asyncio.get_running_loop().time()
        if remaining > 0:
            await default_clock().sleep(remaining)


__all__ = ["WanModel", "LinkScheduler", "build_spec", "DEFAULT_REGIONS"]
