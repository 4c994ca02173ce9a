"""Telemetry instruments: counters, gauges, log-bucket histograms.

A copy of ``hotstuff_tpu.telemetry.metrics``: the same instruments, the
same bucket ladders and byte-equal Prometheus and OpenMetrics text.

Design constraints:

- **No allocation on the hot path.** ``Histogram.observe`` is a bisect
  over a precomputed bound tuple plus integer increments into a
  preallocated count list; ``Counter.inc`` is one integer add.  All
  rendering/percentile work happens at scrape/snapshot time, off the
  consensus path.
- **Pull-model gauges.** Component state that already exists (queue
  depths, pool occupancy, buffer sizes) is read lazily by a callback at
  scrape time instead of being pushed per event — enabling telemetry
  must not add writes to paths that only needed reads.
- **Fixed log-spaced buckets.** One global bucket ladder for latency
  histograms (100 us .. ~200 s, factor 2) so every edge histogram is
  comparable and the Prometheus exposition stays small and static.

Everything here is stdlib-only and independent of the consensus stack;
aggregation lives in ``Registry`` below.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Callable, Iterator

# Log-spaced latency bucket upper bounds, in SECONDS: 100 us doubling up
# to ~209 s (22 finite buckets + overflow).  Spans device-verify sub-ms
# latencies through worst-case view-change backoff (timeout_cap 60 s).
LATENCY_BOUNDS_S: tuple[float, ...] = tuple(1e-4 * 2**i for i in range(22))

# Log-spaced size bucket upper bounds (dimensionless): 1, 2, 4 .. 2^19.
# The batch-size / queue-depth ladder.
SIZE_BOUNDS: tuple[float, ...] = tuple(float(2**i) for i in range(20))


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "help", "labels", "value")

    kind = "counter"

    def __init__(self, name: str, help_: str = "", labels: dict | None = None):
        self.name = name
        self.help = help_
        self.labels = labels or {}
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_json(self):
        return self.value

    def samples(self) -> Iterator[tuple[str, dict, float]]:
        yield self.name, self.labels, self.value


class FloatCounter(Counter):
    """Monotonic float accumulator (wall-clock seconds split lines)."""

    __slots__ = ()

    def __init__(self, name: str, help_: str = "", labels: dict | None = None):
        super().__init__(name, help_, labels)
        self.value = 0.0

    def add(self, v: float) -> None:
        self.value += v

    def to_json(self):
        return round(self.value, 6)


class Gauge:
    """Instantaneous value — either set pushed (``set``) or pulled from a
    zero-argument callback at scrape time (``fn``)."""

    __slots__ = ("name", "help", "labels", "_value", "fn")

    kind = "gauge"

    def __init__(
        self,
        name: str,
        help_: str = "",
        labels: dict | None = None,
        fn: Callable[[], float] | None = None,
    ):
        self.name = name
        self.help = help_
        self.labels = labels or {}
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # noqa: BLE001 — a scrape must never throw
                return -1.0
        return self._value

    def to_json(self):
        v = self.value
        return round(v, 6) if isinstance(v, float) else v

    def samples(self) -> Iterator[tuple[str, dict, float]]:
        yield self.name, self.labels, self.value


class Histogram:
    """Fixed-bucket histogram with log-spaced bounds.

    ``observe`` does no allocation: index = bisect over the bound tuple,
    then three scalar updates.  Percentiles are estimated at snapshot
    time from the cumulative bucket counts (upper-bound estimate — the
    reported pXX is the bucket ceiling, conservative by at most one
    bucket factor).
    """

    __slots__ = ("name", "help", "labels", "bounds", "counts", "count", "sum", "max")

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str = "",
        labels: dict | None = None,
        bounds: tuple[float, ...] = LATENCY_BOUNDS_S,
    ):
        self.name = name
        self.help = help_
        self.labels = labels or {}
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1: overflow (+Inf)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile (0 < q <= 1)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i < len(self.bounds):
                    return self.bounds[i]
                return self.max  # overflow bucket
        return self.max

    def to_json(self, scale: float = 1e3, unit: str = "ms") -> dict:
        """Compact summary (default: seconds -> milliseconds)."""
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            f"mean_{unit}": round(self.sum / self.count * scale, 3),
            f"p50_{unit}": round(self.percentile(0.5) * scale, 3),
            f"p99_{unit}": round(self.percentile(0.99) * scale, 3),
            f"max_{unit}": round(self.max * scale, 3),
        }

    def samples(self) -> Iterator[tuple[str, dict, float]]:
        cum = 0
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            yield (
                self.name + "_bucket",
                {**self.labels, "le": _fmt(bound)},
                cum,
            )
        yield self.name + "_bucket", {**self.labels, "le": "+Inf"}, self.count
        yield self.name + "_sum", self.labels, self.sum
        yield self.name + "_count", self.labels, self.count


def _fmt(v: float) -> str:
    """Shortest exact-enough label for a bucket bound."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class Registry:
    """Ordered collection of instruments, rendered to Prometheus text
    exposition format or a JSON snapshot.

    Instruments are keyed by (name, sorted label items) — registering
    the same key twice returns the existing instrument so process-wide
    singletons (the async verify service) and per-node components can
    idempotently self-register.
    """

    def __init__(self, prefix: str = "hotstuff"):
        self.prefix = prefix
        self._instruments: dict[tuple, object] = {}

    def _key(self, name: str, labels: dict | None) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def _register(self, cls, name, help_, labels, **kw):
        full = f"{self.prefix}_{name}" if self.prefix else name
        key = self._key(full, labels)
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls(full, help_, labels, **kw)
            self._instruments[key] = inst
        return inst

    def counter(self, name: str, help_: str = "", labels: dict | None = None) -> Counter:
        return self._register(Counter, name, help_, labels)

    def float_counter(
        self, name: str, help_: str = "", labels: dict | None = None
    ) -> FloatCounter:
        return self._register(FloatCounter, name, help_, labels)

    def gauge(
        self,
        name: str,
        help_: str = "",
        labels: dict | None = None,
        fn: Callable[[], float] | None = None,
    ) -> Gauge:
        g = self._register(Gauge, name, help_, labels)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(
        self,
        name: str,
        help_: str = "",
        labels: dict | None = None,
        bounds: tuple[float, ...] = LATENCY_BOUNDS_S,
    ) -> Histogram:
        return self._register(Histogram, name, help_, labels, bounds=bounds)

    def __iter__(self):
        return iter(self._instruments.values())

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        seen_meta: set[str] = set()
        for inst in self._instruments.values():
            if inst.name not in seen_meta:
                seen_meta.add(inst.name)
                if inst.help:
                    lines.append(f"# HELP {inst.name} {inst.help}")
                lines.append(f"# TYPE {inst.name} {inst.kind}")
            for sample_name, labels, value in inst.samples():
                lines.append(_sample_line(sample_name, labels, value))
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """OpenMetrics 1.0 text exposition.

        Differences from the 0.0.4 format that real scrapers enforce:
        counter *metadata* names the family without the ``_total``
        suffix while every counter *sample* carries it (instruments
        already named ``*_total`` are not double-suffixed), and the
        exposition terminates with ``# EOF``.
        """
        lines: list[str] = []
        seen_meta: set[str] = set()
        for inst in self._instruments.values():
            family = inst.name
            if inst.kind == "counter" and family.endswith("_total"):
                family = family[: -len("_total")]
            if family not in seen_meta:
                seen_meta.add(family)
                if inst.help:
                    lines.append(f"# HELP {family} {inst.help}")
                lines.append(f"# TYPE {family} {inst.kind}")
            for sample_name, labels, value in inst.samples():
                if inst.kind == "counter" and not sample_name.endswith(
                    "_total"
                ):
                    sample_name += "_total"
                lines.append(_sample_line(sample_name, labels, value))
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _sample_line(sample_name: str, labels: dict, value) -> str:
    if labels:
        lbl = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels.items())
        return f"{sample_name}{{{lbl}}} {_num(value)}"
    return f"{sample_name} {_num(value)}"


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _num(v) -> str:
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


__all__ = [
    "Counter",
    "FloatCounter",
    "Gauge",
    "Histogram",
    "Registry",
    "LATENCY_BOUNDS_S",
    "SIZE_BOUNDS",
]
