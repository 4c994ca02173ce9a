"""CLI: ``python -m hotstuff_tpu_torch.analysis {check,gen-knobs}``."""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import knobgen
from .framework import apply_allowlist, load_allowlist, repo_root, run_rules
from .rules import ALL_RULES

ALLOWLIST_REL = os.path.join("hotstuff_tpu_torch", "analysis", "allowlist.txt")


def cmd_check(args) -> int:
    root = os.path.abspath(args.root)
    allowlist_path = args.allowlist or os.path.join(root, ALLOWLIST_REL)
    findings = run_rules(ALL_RULES, root)
    allow_keys = load_allowlist(allowlist_path)
    kept, used, stale = apply_allowlist(findings, allow_keys)
    if args.json:
        print(
            json.dumps(
                {
                    "findings": [
                        {
                            "rule": f.rule,
                            "path": f.path,
                            "line": f.line,
                            "code": f.code,
                            "key": f.key,
                            "message": f.message,
                        }
                        for f in kept
                    ],
                    "allowlisted": sorted(used),
                    "stale_allowlist": sorted(stale),
                },
                indent=2,
            )
        )
    else:
        for f in kept:
            print(f.render())
        if used:
            print(f"({len(used)} finding(s) suppressed by allowlist)")
        for key in sorted(stale):
            print(f"warning: stale allowlist entry (no such finding): {key}")
        if kept:
            print(f"FAIL: {len(kept)} finding(s)")
        else:
            print("OK: no findings")
    return 1 if kept else 0


def cmd_gen_knobs(args) -> int:
    root = os.path.abspath(args.root)
    if args.check:
        if knobgen.is_fresh(root):
            print(f"OK: {knobgen.KNOBS_REL} is fresh")
            return 0
        print(
            f"STALE: {knobgen.KNOBS_REL} does not match the tree — "
            f"run: python -m hotstuff_tpu_torch.analysis gen-knobs"
        )
        return 1
    path = knobgen.write(root)
    print(f"wrote {path}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m hotstuff_tpu_torch.analysis",
        description="Consensus-aware static analysis plane",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_check = sub.add_parser("check", help="run every lint rule")
    p_check.add_argument("--root", default=repo_root())
    p_check.add_argument("--allowlist", default=None)
    p_check.add_argument("--json", action="store_true")
    p_check.set_defaults(fn=cmd_check)

    p_knobs = sub.add_parser(
        "gen-knobs", help="regenerate (or --check) hotstuff_tpu_torch/analysis/KNOBS.md"
    )
    p_knobs.add_argument("--root", default=repo_root())
    p_knobs.add_argument("--check", action="store_true")
    p_knobs.set_defaults(fn=cmd_gen_knobs)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
