#!/usr/bin/env python3
"""The wave service's routes in the port's committee phases, tree by tree.

    python3 scripts/torch_routes.py [--phases c,e,g] TREE[:VAR=VAL,...] ...

For each TREE in turn (a checkout of the repo: two trees given as
``parent change change parent`` compare two commits on one card), runs
that tree's ``chip_smoke.py`` phases (c) ``committee_phase``, (e)
``node_phase`` and (g) ``node_phase(transport="native")`` (or those
``--phases`` names), each in its own process on the card with the
environment variables given after the tree's colon (for example
``.:HOTSTUFF_STORE_NATIVE=0``), and reads from what each phase prints the wave
service's routes: device, cpu and probe waves, ``ewma_ms``, the mean
wave in signatures, and the verify kernel's launches (after boot where
the tree reports it), with the phase's rounds and payloads a second.
Each phase's output goes to ``chiprun_out/routes/``; one JSON line a
tree and phase is printed, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "routes")
PHASES = {
    "c": "c.committee_phase(card)",
    "e": "c.node_phase(card)",
    "g": "c.node_phase(card, transport='native')",
}
RE_RESULT = re.compile(r"^(committee|node phase|node phase \(native\)) result: (\{.*\})$", re.M)
RE_EWMA = re.compile(r"ewma_ms=([\d.]+)")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def routes(phase: str, result: dict) -> dict:
    """The route figures of one phase's printed result."""
    if phase == "c":
        svc = result["service"] or {}
        stats = {k: svc.get(k) for k in ("dispatches", "device", "cpu", "probe", "device_sigs", "cpu_sigs")}
        stats["ewma_ms"] = float(RE_EWMA.search(svc.get("stats_line", "ewma_ms=0"))[1])
        k1 = result["k1_launches"]
        work = {"blocks_min": min(result["blocks"]), "payloads_per_s": result["payloads_per_s"],
                "latency_mean_s": result["latency_mean_s"],
                "max_loop_lag_ms": round(result["max_loop_lag_s"] * 1e3, 1)}
    else:
        stats = dict(result["stats"] or {})
        total = (result.get("launches") or {}).get("verify_compressed")
        boot = (result.get("boot_launches") or {}).get("verify_compressed")
        # a tree that logs no launches at boot reports its total
        k1 = total - boot if total is not None and boot is not None else total
        work = {"committed_rounds": result["committed_rounds"],
                "payloads_per_s": result["consensus_payloads_per_s"],
                "latency_mean_s": result["latency_mean_s"]}
    waves = max(stats.get("dispatches") or 0, 1)
    mean = ((stats.get("device_sigs") or 0) + (stats.get("cpu_sigs") or 0)) / waves
    return {"device": stats.get("device"), "cpu": stats.get("cpu"), "probe": stats.get("probe"),
            "ewma_ms": stats.get("ewma_ms"), "mean_wave": round(mean, 1), "k1": k1, **work}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)
    card = card_line()
    ok = True
    for i, spec in enumerate(args.trees):
        path, _, env_spec = spec.partition(":")
        env = dict(item.split("=", 1) for item in env_spec.split(",") if item)
        tree = os.path.abspath(path)
        label = ("repo" if tree == ROOT else os.path.basename(tree)) + "".join(
            f"+{k}={v}" for k, v in env.items())
        for phase in args.phases.split(","):
            call = PHASES[phase]
            t0 = time.perf_counter()
            code = f"import chip_smoke as c; card = c.card_line(); {call}"
            try:
                proc = subprocess.run(
                    [sys.executable, "-c", code], cwd=tree, capture_output=True, text=True,
                    env={**os.environ, **env, "PYTHONPATH": tree}, timeout=600,
                )
            except subprocess.TimeoutExpired as e:
                out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
                proc = subprocess.CompletedProcess(e.cmd, 124, out, "timed out after 600 s")
            wall = time.perf_counter() - t0
            log = os.path.join(OUT, f"{i}_{label.replace('=', '-')}_{phase}.log")
            with open(log, "w") as f:
                f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
            found = RE_RESULT.search(proc.stdout)
            row = {"run": i, "tree": label, "phase": phase, "rc": proc.returncode, "wall_s": round(wall, 1)}
            if found:
                row.update(routes(phase, json.loads(found[2])))
            ok &= proc.returncode == 0 and found is not None
            print(json.dumps(row), flush=True)
    print(f"card: {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
