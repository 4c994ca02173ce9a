"""The port's view-change-storm micro-benchmark
(hotstuff_tpu_torch/bench/storm.py) on the CPU at 16 validators: every
verdict of the CPU host and of the device host (``make_verifier("cuda",
device="cpu")``, the kernels' plain versions) is true, and the report has
the JAX benchmark's rows."""

import torch

from benchmark.storm import run_storm as jax_run_storm
from hotstuff_tpu_torch.bench.storm import format_report, run_storm
from hotstuff_tpu_torch.gpu import dsm
from hotstuff_tpu_torch.node.node import LazyDeviceVerifier

torch.set_num_threads(1)


def test_storm_rows_match_the_jax_benchmark(monkeypatch):
    # one small bucket keeps the plain-version waves to 128 lanes, and the
    # plain version takes seconds a wave on a CPU: no deadline may expire
    monkeypatch.setenv("HOTSTUFF_WAVE_BUCKETS", "16")
    monkeypatch.setattr(LazyDeviceVerifier, "dispatch_deadline_s", 600.0, raising=False)
    want = jax_run_storm(nodes=16, bls=False)
    dsm.reset_launches()
    got = run_storm(nodes=16, device=True, torch_device="cpu", bls=False)  # raises on any false verdict
    assert list(got) == ["ed25519-cpu", "ed25519-cuda"]
    assert list(want) == ["ed25519-cpu"]
    assert set(got["ed25519-cpu"]) == set(want["ed25519-cpu"])
    offloop = {"offloop_tc_worst_s", "offloop_max_stall_s"}
    assert set(got["ed25519-cuda"]) == set(want["ed25519-cpu"]) | offloop
    assert all(v >= 0 for row in got.values() for v in row.values())
    assert dsm.launches["verify_compressed"] == 0  # CPU tensors: plain versions
    report = format_report(16, got).splitlines()
    assert "quorum = 11" in report[2]
    assert sum("+ ed25519-" in line for line in report) == 2
    assert sum("OFF-LOOP" in line for line in report) == 1
