"""Telemetry export: the /metrics HTTP endpoint and the snapshot log line.

A copy of ``hotstuff_tpu.telemetry.exporter``: the same routes, bodies
and log lines.

``MetricsServer`` is a deliberately tiny asyncio HTTP/1.0 responder
(stdlib-only — no aiohttp/prometheus_client dependency): it reads one
request, routes on the path, writes one response, closes.  Prometheus
scrapes tolerate (and default to) connection-per-scrape, so the
single-shot shape is correct, and nothing here can hold fds open
against the node's own connection budget.

Routes:

- ``GET /metrics``  — OpenMetrics 1.0 text exposition (correct
  ``Content-Type``, counter families without / samples with the
  ``_total`` suffix, ``# EOF`` terminator) so real Prometheus scrapers
  work against a node unmodified
- ``GET /snapshot`` — the same JSON document the periodic ``Telemetry
  snapshot:`` log line carries, one object per node in this process
- ``GET /trace``    — the newest completed per-round trace records per
  node (the trace ring buffer, ``telemetry/trace.py``)
- ``GET /delta?since=N`` — incremental health-plane export
  (``telemetry/health.py``): a compact JSON delta frame of the flat
  per-node state (gauges, histograms, state-root cursor) against
  sequence ``N``, or a full frame when ``N`` is unknown — a scraper
  pulls O(changed) per tick, not O(all)

``run_snapshot_logger`` is the periodic per-node task: it samples
event-loop lag (the same probe contract as ``utils/workstats.run_probe``
— the direct host-starvation signal) and logs ``Telemetry snapshot:
{json}`` every ``LOG_INTERVAL``.  The JSON is a strict superset of the
``Work stats:`` document, so the scaling harness's scrape contract is
subsumed, not broken.
"""

from __future__ import annotations

import asyncio
import json
import logging

from .health import DeltaStream

log = logging.getLogger(__name__)

OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

LOG_INTERVAL = 5.0
LAG_INTERVAL = 0.05

_HTTP_STATUS = {200: "OK", 404: "Not Found", 405: "Method Not Allowed"}


class MetricsServer:
    """One process-wide scrape endpoint over the shared registry."""

    def __init__(self, registry, host: str = "0.0.0.0", port: int = 0):
        self.registry = registry
        self.host = host
        self.port = port  # 0 = ephemeral; replaced by the bound port
        self._server: asyncio.AbstractServer | None = None
        self._delta = DeltaStream()

    async def start(self) -> "MetricsServer":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("Telemetry /metrics endpoint listening on port %d", self.port)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ---- request handling ----------------------------------------------

    def _route(self, method: str, path: str) -> tuple[int, str, str]:
        """(status, content_type, body) for one request."""
        if method != "GET":
            return 405, "text/plain; charset=utf-8", "method not allowed\n"
        path, _, query = path.partition("?")
        if path == "/metrics":
            return (
                200,
                OPENMETRICS_CONTENT_TYPE,
                self.registry.render_openmetrics(),
            )
        if path == "/delta":
            from . import export_doc

            since = -1
            for part in query.split("&"):
                if part.startswith("since="):
                    try:
                        since = int(part[len("since="):])
                    except ValueError:
                        since = -1
            frame = self._delta.frame(export_doc(), since)
            return (
                200,
                "application/json",
                json.dumps(frame, sort_keys=True) + "\n",
            )
        if path == "/snapshot":
            from . import snapshot_all

            return (
                200,
                "application/json",
                json.dumps(snapshot_all(), sort_keys=True) + "\n",
            )
        if path == "/trace":
            from . import trace_all

            return 200, "application/json", json.dumps(trace_all()) + "\n"
        return 404, "text/plain; charset=utf-8", "not found\n"

    async def _handle(self, reader, writer) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = request.decode("latin-1", "replace").split()
            method, path = (parts + ["", "/"])[:2]
            # drain headers; a scrape sends few — bound the loop anyway
            for _ in range(100):
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            try:
                status, ctype, body = self._route(method, path)
            except Exception:  # noqa: BLE001 — a scrape must never crash
                log.exception("telemetry scrape failed")
                status, ctype, body = 200, "text/plain", "# scrape error\n"
            payload = body.encode()
            writer.write(
                (
                    f"HTTP/1.0 {status} {_HTTP_STATUS.get(status, 'OK')}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode()
                + payload
            )
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass


async def run_snapshot_logger(
    tel, logger=None, sample_lag: bool = True
) -> None:
    """Per-node periodic snapshot: ``Telemetry snapshot: {json}`` every
    LOG_INTERVAL seconds.  When ``sample_lag`` (no separate workstats
    probe running), also feeds the loop-lag probe into the node's
    WorkStats so the snapshot's lag keys are live."""
    logger = logger or log
    loop = asyncio.get_running_loop()
    next_log = loop.time() + LOG_INTERVAL
    stats = getattr(tel, "workstats", None)
    while True:
        if sample_lag and stats is not None:
            t0 = loop.time()
            await asyncio.sleep(LAG_INTERVAL)
            lag = max(loop.time() - t0 - LAG_INTERVAL, 0.0)
            stats.lag_samples += 1
            stats.lag_total_s += lag
            stats.lag_max_s = max(stats.lag_max_s, lag)
        else:
            await asyncio.sleep(LOG_INTERVAL / 8)
        if loop.time() >= next_log:
            next_log = loop.time() + LOG_INTERVAL
            try:
                doc = json.dumps(tel.snapshot(), sort_keys=True)
            except Exception as e:  # noqa: BLE001 — never kill the task
                logger.warning("telemetry snapshot failed: %s", e)
                continue
            # NOTE: this log entry is scraped (benchmark/logs.py) — it
            # subsumes the 'Work stats:' document (superset of its keys).
            logger.info("Telemetry snapshot: %s", doc)


__all__ = [
    "MetricsServer",
    "run_snapshot_logger",
    "LOG_INTERVAL",
    "OPENMETRICS_CONTENT_TYPE",
]
