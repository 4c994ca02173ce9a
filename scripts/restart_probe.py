"""Phase (d) of ``chip_smoke.py`` with the committee's journals on,
read for where the live nodes' rounds go after node 1 crashes.

    python3 scripts/restart_probe.py [--runs 3] [--nodes 64] [--out chiprun_out/restart_probe]

Each run is ``run_committee(nodes, rate=1000, duration=60, restart={"node":
1, "down_at_s": 5.0, "behind_rounds": 16, "deadline_s": 30.0})`` on the
card, as ``chip_smoke.restart_phase`` drives it, with every node's
flight-recorder journal under ``<out>/run<i>/``.  A run whose live nodes
miss the restart's deadline raises in ``run_committee``; the probe
records that and reads the journals either way.  For each run it prints
one JSON line (``restart probe run i: {...}``):

- ``passed`` and the error, the crashed node's index, tag and leader
  positions (round r's leader is the committee's ``r % n``-th key);
- ``timeouts``: each round a node timed out on after the crash, with
  its leader's index, whether that leader is the crashed node, how
  many nodes timed out on it and when the first did (seconds after
  the crash);
- ``sync``: the parent-block requests made after the crash, split by
  whether the child block's author (where the first request goes) is
  the crashed node: how many, how many were answered, and the wait
  from the request to the parent's arrival (min, median, max seconds),
  and how many expired;
- ``progress``: the highest round any live node entered and committed
  at 10, 20 and 30 s after the crash.

``--profile`` runs the committee under ``cProfile`` (which slows the
loop) and prints the functions that took the most time, by own time
and by cumulative time, and writes the whole table to
``<out>/run<i>.prof.txt``.

``--nodes 4 --device cpu --timers 300`` rehearses it on the CPU.  Only
the port is imported.
"""

import argparse
import collections
import json
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_journals(jdir: str) -> dict:
    """node tag -> its records in sequence order (every segment)."""
    import glob

    out = collections.defaultdict(list)
    for path in sorted(glob.glob(os.path.join(jdir, "*.jsonl"))):
        node, records = None, []
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn line
                if rec.get("e") == "meta":
                    node = rec["n"]
                else:
                    records.append(rec)
        out[node].extend(records)
    return {n: sorted(rs, key=lambda r: r["s"]) for n, rs in out.items()}


def crash_time(records) -> float:
    """The wall time (s) of the crashed node's last record before the
    widest silence in its journal: the stop."""
    times = [r["w"] / 1e9 for r in records]
    gaps = [(b - a, a) for a, b in zip(times, times[1:])]
    return max(gaps)[1] if gaps else times[-1]


def _spread(waits) -> list | None:
    return [min(waits), statistics.median(waits), max(waits)] if waits else None


def analyze(jdir: str, tags: list, order: list, k: int) -> dict:
    """What the journals say about the rounds after node ``k`` stopped.
    ``tags[i]`` is node i's journal id, ``order[j]`` the node index of
    the committee's j-th sorted key."""
    n = len(tags)
    index = {t: i for i, t in enumerate(tags)}
    journals = read_journals(jdir)
    crashed = tags[k]
    t_down = crash_time(journals.get(crashed, [{"w": 0}]))
    live = {t: rs for t, rs in journals.items() if t != crashed}
    timeouts = collections.defaultdict(list)
    reqs, dones, expired = {}, {}, 0
    entered, committed = [], []
    for tag, recs in live.items():
        for rec in recs:
            t = rec["w"] / 1e9 - t_down
            if t < 0:
                continue
            e = rec["e"]
            if e == "timeout":
                timeouts[rec["r"]].append(t)
            elif e == "sync.req":
                reqs.setdefault((tag, rec["d"]), (t, rec["p"]))
            elif e == "sync.done":
                dones.setdefault((tag, rec["d"]), t)
            elif e == "sync.expire":
                expired += 1
            elif e == "round.enter":
                entered.append((t, rec["r"]))
            elif e == "commit":
                committed.append((t, rec["r"]))
    rows = []
    for rnd in sorted(timeouts):
        leader = order[rnd % n]
        rows.append({"round": rnd, "leader": leader, "leader_crashed": leader == k,
                     "nodes": len(timeouts[rnd]), "first_s": round(min(timeouts[rnd]), 3)})
    sync = {}
    for label, to_crashed in (("to_crashed_author", True), ("to_live_author", False)):
        keys = [key for key, (_, author) in reqs.items() if (author == crashed[:8]) == to_crashed]
        waits = [dones[key] - reqs[key][0] for key in keys if key in dones]
        sync[label] = {"requests": len(keys), "answered": len(waits), "wait_s": _spread(waits),
                       "authors": sorted({index.get(reqs[key][1], reqs[key][1]) for key in keys}, key=str)[:8]}
    sync["expired"] = expired
    progress = {}
    for at in (10.0, 20.0, 30.0):
        progress[f"{at:.0f}s"] = {
            "entered": max((r for t, r in entered if t <= at), default=None),
            "committed": max((r for t, r in committed if t <= at), default=None),
        }
    return {"crashed": k, "crashed_tag": crashed,
            "crashed_leads": [j for j, i in enumerate(order) if i == k],
            "timeouts": rows, "sync": sync, "progress": progress}


def report_profile(profiler, path: str, top: int = 40) -> None:
    """Print the ``top`` functions by own time and by cumulative time,
    and write the whole table to ``path``."""
    import io
    import pstats

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        pstats.Stats(profiler, stream=f).sort_stats("tottime").print_stats()
    for key in ("tottime", "cumulative"):
        buf = io.StringIO()
        pstats.Stats(profiler, stream=buf).sort_stats(key).print_stats(top)
        text = buf.getvalue()
        print(f"profile by {key}:\n" + text[text.find("ncalls"):], flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--rate", type=int, default=1000)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--device", default=None, help="cpu: the kernels' plain versions")
    ap.add_argument("--timers", type=int, default=None,
                    help="timeout_delay and sync_retry_delay in ms (default: 5,000 and 10,000)")
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--down-at", type=float, default=5.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "restart_probe"))
    ap.add_argument("--profile", action="store_true", help="run under cProfile and print the top functions")
    ap.add_argument("--no-journal", action="store_true", help="journals off (no per-round analysis)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("restart_probe: no CUDA device (pass --device cpu to rehearse)", file=sys.stderr)
        return 2
    from hotstuff_tpu_torch.bench.committee import run_committee
    from hotstuff_tpu_torch.consensus import Committee
    from hotstuff_tpu_torch.crypto.scheme import keygen_deterministic

    seed = 0  # run_committee's default: its keys are these
    keys = [keygen_deterministic("ed25519", seed.to_bytes(32, "little"), i)[0] for i in range(args.nodes)]
    tags = [str(pk)[:8] for pk in keys]
    sorted_keys = Committee.new([(pk, 1, ("127.0.0.1", 1 + i)) for i, pk in enumerate(keys)]).sorted_keys()
    order = [keys.index(pk) for pk in sorted_keys]
    restart = {"node": 1, "down_at_s": args.down_at, "behind_rounds": 16, "deadline_s": args.deadline}
    timers = {} if args.timers is None else {"timeout_delay": args.timers, "sync_retry_delay": args.timers}
    failures = 0
    for i in range(args.runs):
        jdir = os.path.join(args.out, f"run{i}")
        shutil.rmtree(jdir, ignore_errors=True)
        t0 = time.perf_counter()
        error, r = None, None
        profiler = None
        if args.profile:
            import cProfile

            profiler = cProfile.Profile()
            profiler.enable()
        kw = dict(timers) if args.no_journal else {**timers, "journal_dir": jdir}
        try:
            r = run_committee(nodes=args.nodes, rate=args.rate, duration=args.duration, verifier="cuda",
                              device=args.device, restart=restart, **kw)
        except RuntimeError as e:
            error = str(e)
            failures += 1
        finally:
            if profiler is not None:
                profiler.disable()
                report_profile(profiler, os.path.join(args.out, f"run{i}.prof.txt"))
        out = {"run": i, "passed": error is None, "error": error, "wall_s": time.perf_counter() - t0}
        if r is not None:
            sync = r["state_sync"]
            out.update(timeouts_total=r["timeouts"], blocks=[min(r["blocks"]), max(r["blocks"])],
                       rounds_behind=sync["rounds_behind"], restart_at_s=sync["restart_at_s"],
                       down_to_restart_s=sync["restart_at_s"] - sync["down_at_s"],
                       first_commit_s=sync["first_commit_s"], chains_agree=r["chains_agree"],
                       max_loop_lag_s=r["max_loop_lag_s"])
        if not args.no_journal:
            out.update(analyze(jdir, tags, order, restart["node"]))
        print(f"restart probe run {i}: " + json.dumps(out), flush=True)
    print(f"restart probe: {args.runs - failures} of {args.runs} runs reached the restart within "
          f"{args.deadline} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
