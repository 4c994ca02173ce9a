"""The port's static analysis plane (``hotstuff_tpu_torch/analysis``)
against the reference's (``hotstuff_tpu/analysis``) on the CPU.

Parity: every fixture tree of ``tests/test_analysis.py`` (and two of the
clock-discipline rule, which that file has none of) is written once
under a ``hotstuff_tpu/...`` root and once, the same bytes, under a
``hotstuff_tpu_torch/...`` root (``tpu/`` read as ``gpu/``); both
packages' ``run_rules`` must give the same rule, line, code and message
once the package names are normalised, for the fixture's own rule and
for ``ALL_RULES``.  Then the allowlist, the port's real tree (no
finding, an empty allowlist), the knob tables (the port's fresh, the
JAX ``docs/KNOBS.md`` byte for byte as committed), the CLI and
``chip_smoke.py``'s phase (r).  Every path is under ``tmp_path`` and
every subprocess has a timeout.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

from hotstuff_tpu.analysis import framework as ref_framework
from hotstuff_tpu.analysis import knobgen as ref_knobgen
from hotstuff_tpu.analysis import rules as ref_rules
from hotstuff_tpu_torch.analysis import Finding, load_allowlist, run_rules
from hotstuff_tpu_torch.analysis import framework, knobgen, rules
from hotstuff_tpu_torch.analysis.__main__ import ALLOWLIST_REL
from hotstuff_tpu_torch.analysis.framework import apply_allowlist, repo_root

REPO = repo_root()
CLI_TIMEOUT_S = 120
# docs/KNOBS.md as committed: the JAX package's table, which no port
# command writes
JAX_KNOBS_SHA256 = "48b2c4ce7c2037aa2e27defe68c1e04d893dbe99c7f8b528378eafb1981d56c9"


def _port_rel(rel: str) -> str:
    """A reference tree path in the port's tree."""
    if rel.startswith("hotstuff_tpu/tpu/"):
        return "hotstuff_tpu_torch/gpu/" + rel[len("hotstuff_tpu/tpu/"):]
    if rel.startswith("hotstuff_tpu/"):
        return "hotstuff_tpu_torch/" + rel[len("hotstuff_tpu/"):]
    return rel


def _normalise(text: str) -> str:
    """The port's names in a finding written as the reference's."""
    return (
        text.replace(knobgen.KNOBS_REL, ref_knobgen.KNOBS_REL)
        .replace("hotstuff_tpu_torch/gpu/", "hotstuff_tpu/tpu/")
        .replace("hotstuff_tpu_torch", "hotstuff_tpu")
    )


def _rows(findings, normalise: bool = False) -> list:
    fix = _normalise if normalise else (lambda t: t)
    return [(f.rule, fix(f.path), f.line, fix(f.code), fix(f.message)) for f in findings]


def _write(root, files: dict, port: bool) -> None:
    for rel, text in files.items():
        path = root / (_port_rel(rel) if port else rel)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))


# ---------------------------------------------------------------------------
# the fixture trees of tests/test_analysis.py, by the rule each exercises


_KNOB_TREE = {
    "hotstuff_tpu/__init__.py": """\
        import os

        WINDOW = int(os.environ.get("HOTSTUFF_FIXTURE_WINDOW", "64"))
        """,
}

_RACY_CLASS = """\
    import threading


    class Service:
        def __init__(self):
            self.count = 0
            self._thread = threading.Thread(target=self._worker)

        def _worker(self):
            self.count += 1

        def snapshot(self):
            return self.count
    """

_LOCKSET = """\
    import threading


    class Service:
        def __init__(self):
            self._mu = threading.Lock()
            self.count = 0
            self._thread = threading.Thread(target=self._worker)

        def _worker(self):
            with self._mu:
                # guarded-by: _mu
                self.count += 1

        def reset(self):
            {reset}
    """

# name -> (rule class, files, codes the reference's test expects,
#          files added after the knob table was written, or None)
FIXTURES = {
    "blocking_sync_calls_in_async_def": ("NoBlockingInAsync", {
        "hotstuff_tpu/consensus/actor.py": """\
            import time


            async def propose(self, fut, sock):
                time.sleep(0.1)
                stake = fut.result()
                value = self.store.engine.get(b"k")
                data = sock.recv(1024)
                return stake, value, data
            """,
    }, {"time.sleep", "fut.result", "self.store.engine.get", "sock.recv"}, None),
    "blocking_ignores_sync_defs_and_nested_functions": ("NoBlockingInAsync", {
        "hotstuff_tpu/consensus/actor.py": """\
            import time


            def sync_helper():
                time.sleep(1)  # sync context: out of scope


            async def run(self, loop):
                def callback():
                    time.sleep(1)  # nested def: different schedule

                await loop.run_in_executor(None, callback)
                result = await self.task  # awaited, not blocking
                return result
            """,
    }, set(), None),
    "blocking_respects_inline_allow": ("NoBlockingInAsync", {
        "hotstuff_tpu/consensus/actor.py": """\
            async def tally(done):
                total = 0
                for t in done:
                    # t is in asyncio.wait's done set: result() is an
                    # immediate read, never a block
                    # lint: allow(no-blocking-in-async)
                    total += t.result()
                return total
            """,
    }, set(), None),
    "allow_marker_anywhere_in_comment_block": ("NoBlockingInAsync", {
        "hotstuff_tpu/consensus/actor.py": """\
            async def tally(t):
                # lint: allow(no-blocking-in-async)
                # a multi-line justification sits between the marker
                # and the flagged call; the contiguous block carries it
                return t.result()
            """,
    }, set(), None),
    "allow_for_a_different_rule_does_not_suppress": ("NoBlockingInAsync", {
        "hotstuff_tpu/consensus/actor.py": """\
            async def tally(t):
                # lint: allow(wire-decoder-bounds)
                return t.result()
            """,
    }, {"t.result"}, None),
    "wire_bounds_unbounded_count": ("WireDecoderBounds", {
        "hotstuff_tpu/consensus/wire.py": """\
            def decode_votes(dec):
                n = dec.u32()
                return [dec.raw(64) for _ in range(n)]
            """,
    }, {"decode_votes:n"}, None),
    "wire_bounds_bounded_count": ("WireDecoderBounds", {
        "hotstuff_tpu/consensus/wire.py": """\
            MAX = 4096


            def decode_votes(dec):
                n = dec.u32()
                if n > MAX:
                    raise ValueError("vote count over cap")
                return [dec.raw(64) for _ in range(n)]
            """,
    }, set(), None),
    "wire_bounds_equality_check_is_not_a_bound": ("WireDecoderBounds", {
        "hotstuff_tpu/consensus/wire.py": """\
            SENTINEL = 0xFFFFFFFF


            def decode_votes(dec):
                n = dec.u32()
                if n == SENTINEL:
                    return None
                return [dec.raw(64) for _ in range(n)]
            """,
    }, {"decode_votes:n"}, None),
    "wire_bounds_uncapped_var_bytes": ("WireDecoderBounds", {
        "hotstuff_tpu/consensus/wire.py": """\
            def decode_blob(dec):
                return dec.var_bytes()
            """,
    }, {"decode_blob:var_bytes"}, None),
    "wire_bounds_capped_var_bytes": ("WireDecoderBounds", {
        "hotstuff_tpu/consensus/wire.py": """\
            def decode_blob(dec):
                return dec.var_bytes(1024)
            """,
    }, set(), None),
    "taxonomy_unregistered_edge_and_stage": ("TaxonomyRegistry", {
        "hotstuff_tpu/consensus/core.py": """\
            def on_commit(self, j, rec, block, t0, dur):
                j.record("commmit", block.digest())  # typo
                j.record("commit", block.digest())   # registered
                rec.add("dispatch.typo", t0, dur)    # unregistered
                rec.add("dispatch", t0, dur)         # registered
            """,
    }, {"edge:commmit", "stage:dispatch.typo"}, None),
    "taxonomy_dynamic_edges_need_registered_prefix": ("TaxonomyRegistry", {
        "hotstuff_tpu/faults_like.py": "",
        "hotstuff_tpu/consensus/core.py": """\
            def on_fault(self, j, kind):
                j.record(f"fault.{kind}", None)  # registered prefix
                j.record(f"byz.{kind}", None)    # registered prefix
                j.record(f"oops.{kind}", None)   # unregistered
            """,
    }, {"edge:<dynamic>"}, None),
    "taxonomy_ignores_non_journal_receivers": ("TaxonomyRegistry", {
        "hotstuff_tpu/consensus/core.py": """\
            def run(self, metrics):
                metrics.record("whatever.metric", 1)
            """,
    }, set(), None),
    "env_knob_missing_table": ("EnvKnobRegistry", _KNOB_TREE, {"missing"}, None),
    "env_knob_regenerated_table": ("EnvKnobRegistry", _KNOB_TREE, set(), {}),
    "env_knob_stale_table": ("EnvKnobRegistry", _KNOB_TREE, {"stale"}, {
        "hotstuff_tpu/extra.py": 'import os\nN = int(os.getenv("HOTSTUFF_FIXTURE_NEW", "8"))\n',
    }),
    "guarded_by_unannotated_cross_thread_field": ("GuardedBy", {
        "hotstuff_tpu/telemetry/svc.py": _RACY_CLASS,
    }, {"Service.count"}, None),
    "guarded_by_documented_discipline": ("GuardedBy", {
        "hotstuff_tpu/telemetry/svc.py": _RACY_CLASS.replace(
            "self.count += 1", "# guarded-by: gil\n            self.count += 1"),
    }, set(), None),
    "guarded_by_lockset_unlocked_write": ("GuardedBy", {
        "hotstuff_tpu/telemetry/svc.py": _LOCKSET.replace(
            "{reset}", "self.count = 0  # write without holding _mu"),
    }, {"Service.count:unlocked"}, None),
    "guarded_by_lockset_every_write_holds_lock": ("GuardedBy", {
        "hotstuff_tpu/telemetry/svc.py": _LOCKSET.replace(
            "{reset}", "with self._mu:\n                self.count = 0"),
    }, set(), None),
    "guarded_by_drift_without_thread_creation": ("GuardedBy", {
        "hotstuff_tpu/tpu/dev.py": """\
            import threading


            class Cache:
                def __init__(self):
                    self._mu = threading.Lock()
                    self.slots = {}

                def insert(self, k, v):
                    with self._mu:
                        self.slots[k] = v

                def wipe(self):
                    self.slots = {}
            """,
    }, {"Cache.slots:drift"}, None),
    "unparseable_target": ("WireDecoderBounds", {
        "hotstuff_tpu/consensus/wire.py": "def broken(:\n",
    }, {"syntax-error"}, None),
    "cli_violation_fixture": ("WireDecoderBounds", {
        "hotstuff_tpu/__init__.py": "",
        "hotstuff_tpu/consensus/wire.py": """\
            def decode_votes(dec):
                n = dec.u32()
                return [dec.raw(64) for _ in range(n)]
            """,
    }, {"decode_votes:n"}, {}),
    "clock_discipline_flags_reaching_around_the_seam": ("ClockDiscipline", {
        "hotstuff_tpu/network/pacer.py": """\
            import asyncio
            import random
            import time


            async def pace(rng):
                t = time.time()
                m = time.monotonic()
                await asyncio.sleep(0.1)
                pick = random.choice([1, 2])
                own = random.Random(7).random()  # a seeded generator: legal
                ok = rng.uniform(0, 1)           # the seam in use
                return t, m, pick, own, ok
            """,
    }, {"time.time", "time.monotonic", "asyncio.sleep", "random.choice"}, None),
    "clock_discipline_respects_inline_allow": ("ClockDiscipline", {
        "hotstuff_tpu/faults/stamp.py": """\
            import time


            def boot_stamp():
                # lint: allow(clock-discipline) -- a process start stamp
                # wants real time
                return time.monotonic()
            """,
    }, set(), None),
}


def _both_trees(tmp_path, name: str):
    """(reference root, port root) of fixture ``name``, each with its
    package's knob table written and the later files added where the
    fixture says so."""
    _rule, files, _codes, after = FIXTURES[name]
    roots = []
    for port, pkg_knobgen in ((False, ref_knobgen), (True, knobgen)):
        root = tmp_path / ("port" if port else "reference")
        _write(root, files, port)
        if after is not None:
            pkg_knobgen.write(str(root))
            _write(root, after, port)
        roots.append(str(root))
    return roots


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rules_match_the_reference_on_every_fixture(tmp_path, name):
    rule, _files, codes, _after = FIXTURES[name]
    ref_root, port_root = _both_trees(tmp_path, name)
    ref = ref_framework.run_rules([getattr(ref_rules, rule)()], ref_root)
    port = framework.run_rules([getattr(rules, rule)()], port_root)
    assert {f.code for f in ref} == codes  # what tests/test_analysis.py asserts
    assert _rows(port, normalise=True) == _rows(ref)
    assert all(f.path.startswith("hotstuff_tpu_torch/") for f in port)
    # every rule at once, as the CLI runs them
    assert _rows(framework.run_rules(rules.ALL_RULES, port_root), normalise=True) == _rows(
        ref_framework.run_rules(ref_rules.ALL_RULES, ref_root))


def test_rule_registry_is_the_references_in_order():
    assert [r.name for r in rules.ALL_RULES] == [r.name for r in ref_rules.ALL_RULES]
    assert [type(r).__name__ for r in rules.ALL_RULES] == [type(r).__name__ for r in ref_rules.ALL_RULES]
    for ours, theirs in zip(rules.ALL_RULES, ref_rules.ALL_RULES):
        assert [_normalise(t) for t in ours.targets] == [
            t for t in theirs.targets if not t.startswith("benchmark/")]


def test_knobgen_discovers_what_the_reference_does(tmp_path):
    files = {
        "hotstuff_tpu/knobs.py": """\
            import os


            def _env_int(name, default):
                return int(os.environ.get(name, str(default)))


            A = _env_int("HOTSTUFF_FIXTURE_HELPER", 512)
            B = os.environ["HOTSTUFF_FIXTURE_SUBSCRIPT"]
            C = "HOTSTUFF_FIXTURE_MEMBER" in os.environ
            """,
        # the scanner's own module is not a read, in either package
        "hotstuff_tpu/analysis/knobgen.py": 'K = "HOTSTUFF_FIXTURE_SELF" in env\n',
    }
    _write(tmp_path / "reference", files, port=False)
    _write(tmp_path / "port", files, port=True)
    ref = ref_knobgen.scan(str(tmp_path / "reference"))
    port = knobgen.scan(str(tmp_path / "port"))
    assert set(port) == set(ref) == {
        "HOTSTUFF_FIXTURE_HELPER", "HOTSTUFF_FIXTURE_SUBSCRIPT", "HOTSTUFF_FIXTURE_MEMBER"}
    assert port["HOTSTUFF_FIXTURE_HELPER"]["defaults"] == ["512"]
    assert {k: {"defaults": v["defaults"], "modules": [_normalise(m) for m in v["modules"]]}
            for k, v in port.items()} == ref
    ours = knobgen.render(str(tmp_path / "port"))
    theirs = ref_knobgen.render(str(tmp_path / "reference"))
    assert "python -m hotstuff_tpu_torch.analysis gen-knobs" in ours
    assert _normalise(ours.split("|------|---------|---------|\n")[1]) == theirs.split(
        "|------|---------|---------|\n")[1]
    assert "3 knobs registered." in ours


# ---------------------------------------------------------------------------
# allowlist


def test_allowlist_round_trip_and_stale_detection(tmp_path):
    findings = [Finding("r", "a.py", 3, "x", "m1"), Finding("r", "b.py", 9, "y", "m2")]
    path = tmp_path / "allowlist.txt"
    path.write_text("# grandfathered\n\n" f"{findings[0].key}\n" "r:gone.py:z\n")
    keys = load_allowlist(str(path))
    assert keys == {"r:a.py:x", "r:gone.py:z"} == ref_framework.load_allowlist(str(path))
    kept, used, stale = apply_allowlist(findings, keys)
    assert [f.key for f in kept] == ["r:b.py:y"]
    assert used == {"r:a.py:x"}
    assert stale == {"r:gone.py:z"}
    assert load_allowlist(str(tmp_path / "absent.txt")) == set()


def test_finding_keys_are_line_number_free():
    a = Finding("r", "p.py", 10, "tok", "m")
    b = Finding("r", "p.py", 99, "tok", "m")
    assert a.key == b.key == "r:p.py:tok"
    assert "10" in a.render() and "[r]" in a.render()
    assert a.render() == ref_framework.Finding("r", "p.py", 10, "tok", "m").render()


def test_allowlist_is_the_references_header_and_no_key():
    ours = os.path.join(REPO, ALLOWLIST_REL)
    with open(ours, encoding="utf-8") as f, open(
            os.path.join(REPO, "hotstuff_tpu", "analysis", "allowlist.txt"), encoding="utf-8") as g:
        assert f.read() == g.read()
    assert load_allowlist(ours) == set()


# ---------------------------------------------------------------------------
# the real tree and the knob tables


def test_real_tree_passes_clean():
    findings = run_rules(rules.ALL_RULES, REPO)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_knob_table_is_fresh_and_the_jax_one_untouched():
    assert knobgen.KNOBS_REL == "hotstuff_tpu_torch/analysis/KNOBS.md"
    assert knobgen.is_fresh(REPO)
    with open(os.path.join(REPO, "docs", "KNOBS.md"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == JAX_KNOBS_SHA256
    assert ref_knobgen.is_fresh(REPO)


# ---------------------------------------------------------------------------
# the CLI


def _cli(*argv, root=None) -> subprocess.CompletedProcess:
    args = [sys.executable, "-m", "hotstuff_tpu_torch.analysis", *argv]
    if root is not None:
        args += ["--root", str(root)]
    return subprocess.run(args, capture_output=True, text=True, cwd=REPO, timeout=CLI_TIMEOUT_S)


def test_cli_exits_1_on_a_violation_and_0_once_fixed(tmp_path):
    _write(tmp_path, FIXTURES["cli_violation_fixture"][1], port=True)
    knobgen.write(str(tmp_path))  # keep the knob rule out of this fixture's way
    dirty = _cli("check", root=tmp_path)
    assert dirty.returncode == 1
    assert "wire-decoder-bounds" in dirty.stdout and "FAIL" in dirty.stdout
    as_json = _cli("check", "--json", root=tmp_path)
    assert as_json.returncode == 1
    assert [f["key"] for f in json.loads(as_json.stdout)["findings"]] == [
        "wire-decoder-bounds:hotstuff_tpu_torch/consensus/wire.py:decode_votes:n"]
    (tmp_path / "hotstuff_tpu_torch" / "consensus" / "wire.py").write_text(textwrap.dedent("""\
        def decode_votes(dec):
            n = dec.u32()
            if n > 4096:
                raise ValueError("over cap")
            return [dec.raw(64) for _ in range(n)]
        """))
    clean = _cli("check", root=tmp_path)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "OK: no findings" in clean.stdout


def test_cli_on_the_tree_and_gen_knobs_writes_only_the_ports_table(tmp_path):
    tree = _cli("check")
    assert tree.returncode == 0, tree.stdout + tree.stderr
    assert tree.stdout.strip() == "OK: no findings"
    fresh = _cli("gen-knobs", "--check")
    assert fresh.returncode == 0 and fresh.stdout.startswith("OK:"), fresh.stdout
    _write(tmp_path, _KNOB_TREE, port=True)
    assert _cli("gen-knobs", "--check", root=tmp_path).returncode == 1
    wrote = _cli("gen-knobs", root=tmp_path)
    assert wrote.returncode == 0, wrote.stderr
    assert sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*.md")) == [
        "hotstuff_tpu_torch/analysis/KNOBS.md"]
    assert "HOTSTUFF_FIXTURE_WINDOW" in (tmp_path / knobgen.KNOBS_REL).read_text()
    assert _cli("gen-knobs", "--check", root=tmp_path).returncode == 0


def test_chip_smoke_phase_r_passes_on_the_cpu(tmp_path, monkeypatch):
    import tempfile

    import chip_smoke

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the planted root
    out = chip_smoke.analysis_phase("cpu")
    assert out["check"]["rc"] == 0 and out["planted"]["rc"] == 1
    assert out["wall_s"] < chip_smoke.ANALYSIS_BUDGET_S
