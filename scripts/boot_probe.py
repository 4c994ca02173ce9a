#!/usr/bin/env python3
"""Phase (g) of ``chip_smoke.py`` alone, several times, with its node
process's boot sampled: where a 64-node ``run-many`` spends its boot;
or, with ``--phase split``, phase (n1) alone several times.

    python3 scripts/boot_probe.py [--tree DIR] [--runs 6] [--out DIR] [--phase boot|split]

Needs a CUDA card (phase (g) runs ``--verifier cuda``).  ``--tree`` runs
the phase of another checkout (a ``git archive`` of another commit
unpacked into a git-ignored directory), this one's by default.  Builds
the tree's kernels and g++ libraries first, as step 1 of its
``chip_smoke.py`` does, then runs ``node_phase(card, transport="native")``
``--runs`` times.  The node process runs under this script's sampler
(``--sample``): a thread records every thread's stack every 20 ms for
the first 25 s.  Each run's node log and samples land in
``--out/run<i>/`` (default ``chiprun_out/boot_probe``), and a line a
run gives its verdict, this checkout's ``boot_timeline`` of the node
log (boot spread, first node's boot, last boot to block 1, block 1 to
block 2, round-1 timeouts, fd probe) and the seconds from the process's
start to the first node's spawn by what the main thread was doing
(imports, ``Node.new``'s steps, the rest).

``--phase split`` runs phase (e) (``node_phase``) once for the boot time
(n1) opens its window after, then ``split_brain_phase`` ``--runs`` times,
unsampled.  Before each run it prints the live child processes
(``live_children``).  Each run prints the phase's own lines, its ``cut
timeline`` among them (the window, the node process's boot, the first
commit and the last round committed before the open, nodes that timed
out in the 10 s before the cut, the first timeout after it, the nodes
whose first one ran after the heal), a failed run's too, then a line
with its verdict; its node log is kept, gzipped, under ``--out``.  A run whose committee committed nothing before the
window opened is inconclusive: the cut it was to test fell before any
round did.  The last line counts the passes among the conclusive runs,
the inconclusive runs, and over all runs the committee's stalls (no
commit before the window, or fewer than 5 committed blocks a node).
"""

from __future__ import annotations

import argparse
import collections
import gc
import gzip
import importlib.util
import json
import os
import runpy
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SAMPLE_EVERY_S = 0.02
SAMPLE_FOR_S = 25.0


def _stack(frame, depth: int) -> str:
    out = []
    while frame is not None and len(out) < depth:
        out.append(f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_code.co_name}:{frame.f_lineno}")
        frame = frame.f_back
    return " < ".join(out)


def sample_and_run_node(path: str, argv: list) -> None:
    """Run ``python -m hotstuff_tpu_torch.node argv`` in this process with
    a sampling thread writing ``<unix time> MAIN <stack> || <thread> <stack>``
    lines and garbage-collection pauses over 20 ms to ``path``."""
    out = open(path, "w", buffering=1)
    main = threading.main_thread()
    gc_start = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_start["t"] = time.perf_counter()
        elif "t" in gc_start:
            pause = time.perf_counter() - gc_start.pop("t")
            if pause > 0.02:
                out.write(f"{time.time():.3f} GC gen{info['generation']} {pause * 1e3:.0f} ms\n")

    def sampler():
        me = threading.get_ident()
        end = time.time() + SAMPLE_FOR_S
        while time.time() < end:
            frames = sys._current_frames()
            line = [f"{time.time():.3f} MAIN {_stack(frames.get(main.ident), 14)}"]
            line += [f"   T{ident % 10000} {_stack(f, 4)}" for ident, f in frames.items()
                     if ident not in (main.ident, me)]
            out.write(" ||".join(line) + "\n")
            time.sleep(SAMPLE_EVERY_S)
        out.write("sampler done\n")

    gc.callbacks.append(on_gc)
    threading.Thread(target=sampler, daemon=True).start()
    sys.argv = ["hotstuff_tpu_torch.node", *argv]
    runpy.run_module("hotstuff_tpu_torch.node", run_name="__main__", alter_sys=True)


def boot_split(samples_path: str, first_spawn: float) -> dict:
    """Seconds from the first sample to ``first_spawn`` (unix time) by what
    the main thread was doing: ``import``, ``Node.new <step>`` or the
    innermost frame's function."""
    split = collections.Counter()
    prev = None
    with open(samples_path) as f:
        for line in f:
            if " MAIN " not in line:
                continue
            t = float(line.split()[0])
            if t > first_spawn:
                break
            stack = line.split(" MAIN ", 1)[1].split(" ||")[0]
            node = [fr for fr in stack.split(" < ") if fr.startswith("node.py:")]
            if node:
                key = "Node.new " + node[0].split(":")[1]
            elif "importlib" in stack:
                key = "import"
            else:
                key = stack.split(" < ")[0].rsplit(":", 1)[0]
            if prev is not None:
                split[key] += t - prev
            prev = t
    return {k: round(v, 2) for k, v in split.most_common(8)}


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_runs(smoke, card: str, runs: int, out: str) -> int:
    """(e) once, then (n1) ``runs`` times; a failed check is a verdict,
    a run with no commit before the window is inconclusive, and the
    committee's stalls are counted over all runs.  Each run's node log
    is kept as ``out/split<i>.nodes.log.gz``."""
    _launches, base = smoke.node_phase(card)
    print(f"(e) boot {base['boot_s']:.2f} s", flush=True)
    passed = inconclusive = stalled = 0
    for i in range(runs):
        print(f"split run {i}: live children before it {smoke.live_children()}", flush=True)
        t0 = time.perf_counter()
        try:
            timeline = smoke.split_brain_phase(card, base)[1]["split_brain"]["split_timeline"]
            verdict = "pass"
        except Exception as e:  # noqa: BLE001 — a failed run is a result here
            timeline, verdict = getattr(e, "split_brain", None), f"FAIL ({e})"
        wall = time.perf_counter() - t0
        log = os.path.join(smoke.ROOT, "chiprun_out", "split-brain_phase", "nodes.log")
        if os.path.exists(log):
            os.makedirs(out, exist_ok=True)
            with open(log, "rb") as f, gzip.open(os.path.join(out, f"split{i}.nodes.log.gz"), "wb") as g:
                shutil.copyfileobj(f, g)
        if timeline is None:
            print(f"split run {i}: {verdict} in {wall:.1f} s, before its node process logged [{card}]",
                  flush=True)
            continue
        first = timeline["first_commit_s"]
        no_commit = first is None or first > timeline["window_s"][0]
        if no_commit or "at least 5 committed blocks a node" in verdict:
            stalled += 1
        if no_commit:
            verdict = f"INCONCLUSIVE, no commit before the window ({verdict})"
            inconclusive += 1
        elif verdict == "pass":
            passed += 1
        print(f"split run {i}: {verdict} in {wall:.1f} s [{card}]", flush=True)
    print(f"split runs: {passed} of {runs - inconclusive} conclusive runs passed, {inconclusive} inconclusive; "
          f"the committee stalled (no commit before the window, or under 5 committed blocks a node) in "
          f"{stalled} of {runs} runs [{card}]")
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--sample":
        sample_and_run_node(sys.argv[2], sys.argv[3:])
        return 0
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--runs", type=int, default=6)
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "boot_probe"))
    parser.add_argument("--phase", choices=("boot", "split"), default="boot")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    ours = _module("boot_probe_smoke", os.path.join(ROOT, "chip_smoke.py"))
    os.chdir(tree)
    sys.path.insert(0, tree)
    smoke = _module("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    from hotstuff_tpu_torch import _native_build
    from hotstuff_tpu_torch.gpu import _build

    card = smoke.card_line()
    t0 = time.perf_counter()
    _build.build_all()
    libs = [_native_build.build(name) for name in _native_build.LIBRARIES]
    print(f"card: {card}; tree {tree}; built in {time.perf_counter() - t0:.1f} s: "
          f"{[p.name for p in libs]}", flush=True)
    if args.phase == "split":
        return split_runs(smoke, card, args.runs, args.out)
    popen = subprocess.Popen
    run = {"i": 0}

    def sampled_popen(cmd, *a, **kw):
        if list(cmd[1:3]) == ["-m", "hotstuff_tpu_torch.node"] and "run-many" in cmd:
            samples = os.path.join(args.out, f"run{run['i']}", "samples.txt")
            cmd = [cmd[0], os.path.abspath(__file__), "--sample", samples, *cmd[3:]]
        return popen(cmd, *a, **kw)

    smoke.subprocess.Popen = sampled_popen
    for i in range(args.runs):
        run["i"] = i
        where = os.path.join(args.out, f"run{i}")
        os.makedirs(where, exist_ok=True)
        t0 = time.perf_counter()
        try:
            smoke.node_phase(card, transport="native")
            verdict = "pass"
        except Exception as e:  # noqa: BLE001 — a failed run is a result here
            verdict = f"FAIL ({e})"
        wall = time.perf_counter() - t0
        logs = os.path.join(tree, "chiprun_out", "node_phase_native")
        for name in ("nodes.log", "client.log"):
            shutil.copy(os.path.join(logs, name), where)
        with open(os.path.join(where, "nodes.log")) as f:
            text = f.read()
        timeline = ours.boot_timeline(text)
        spawn = ours.RE_SPAWN.search(text)
        split = boot_split(os.path.join(where, "samples.txt"), ours._ts(spawn[1])) if spawn else {}
        print(f"run {i}: {verdict} in {wall:.1f} s; " + json.dumps(timeline)
              + "; before the first spawn (s): " + json.dumps(split) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
