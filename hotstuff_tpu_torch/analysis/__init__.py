"""hotstuff_tpu_torch.analysis — the consensus-aware static analysis plane.

A copy of ``hotstuff_tpu.analysis`` aimed at this package's tree: the
rules, their logic and their messages are the reference's; only the
paths and the command name say ``hotstuff_tpu_torch`` (and ``gpu/``
where the reference says ``tpu/``).

A custom AST lint framework (stdlib ``ast`` + ``tokenize``, zero
third-party deps) whose rules encode this codebase's load-bearing
conventions instead of generic style:

- **no-blocking-in-async** — no ``time.sleep`` / ``Future.result()`` /
  ``block_until_ready`` / synchronous store or socket calls lexically
  inside ``async def`` bodies (``consensus/``, ``network/``, ``node/``):
  a blocking call on the event loop stalls the pacemaker and breaks the
  honest-node timeliness assumption of the trusted-subset regime.
- **wire-decoder-bounds** — every length/count a wire decoder reads must
  pass an ordering comparison before it drives a slice or a decode loop
  (``consensus/wire.py``, ``consensus/messages.py``), so a new frame tag
  cannot ship the allocation-bomb bug class the fuzz corpus only catches
  after the fact.
- **taxonomy-registry** — journal edge names and verify-pipeline span
  stage names must come from ``telemetry/taxonomy.py`` (which
  ``telemetry/traces.py`` also renders from): an unregistered edge is a
  lint error, not a silently-empty Perfetto track.
- **env-knob-registry** — every ``HOTSTUFF_*`` knob the code reads must
  appear in the generated ``hotstuff_tpu_torch/analysis/KNOBS.md``
  (kept fresh by this rule).
- **guarded-by** — fields touched from both a dispatch-loop thread and
  the asyncio loop must carry a ``# guarded-by: <lock>`` annotation; a
  lockset walker checks annotated locks are actually held at writes.

Escape hatches, in preference order: fix the finding; suppress one site
with ``# lint: allow(<rule>)  -- <why>`` on (or directly above) the
flagged line; grandfather it in ``analysis/allowlist.txt`` (one
``rule:path:code`` key per line — the list is committed and expected to
stay empty or justified).

CLI::

    python -m hotstuff_tpu_torch.analysis check [--json]
    python -m hotstuff_tpu_torch.analysis gen-knobs [--check]

``chip_smoke.py``'s phase (r) runs both and a planted violation;
``tests/test_torch_analysis.py`` holds every rule to the reference's.
"""

from .framework import Finding, SourceFile, load_allowlist, run_rules

__all__ = ["Finding", "SourceFile", "load_allowlist", "run_rules"]
