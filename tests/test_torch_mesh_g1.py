"""The port's sharded G1 aggregate (hotstuff_tpu_torch/gpu/bls.py
``make_sharded_g1_aggregate``, ``G1Aggregator(mesh=...)``) on virtual CPU
meshes against the JAX package's ``make_sharded_g1_aggregate`` on the
conftest's virtual 8-device CPU mesh and against the oracle
(``crypto/bls/curve.py`` ``G1Point.sum``).

Tolerance: none.  The port stages plain rows and sums each shard with
B4's plain version, then the Montgomery partials; JAX stages Montgomery
rows.  Both run the same formulas in the same tree order, so X, Y and Z
agree as integers mod q.  JAX is compared at 8 and 32 points only: its
int32 columns overflow on deeper trees (ROADMAP section C, F3)."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hotstuff_tpu.parallel.mesh import default_mesh as jax_default_mesh
from hotstuff_tpu.tpu import bls as J
from hotstuff_tpu_torch.crypto import bls as tbls
from hotstuff_tpu_torch.crypto.bls.curve import G1Point
from hotstuff_tpu_torch.crypto.bls.fields import P as Q
from hotstuff_tpu_torch.crypto.bls.service import BlsVerifier
from hotstuff_tpu_torch.crypto.scheme import make_device_verifier
from hotstuff_tpu_torch.gpu import bls as G
from hotstuff_tpu_torch.parallel.mesh import DP_AXIS, Mesh

torch.set_num_threads(1)
SEED = 20261017
CPU = torch.device("cpu")


def _pts(n: int, seed: int = SEED) -> list[G1Point]:
    """n subgroup points from a seed: k0*G, then steps of d*G."""
    rng = random.Random(seed)
    p = G1Point.generator().mul(rng.randrange(1, 2**64))
    d = G1Point.generator().mul(rng.randrange(1, 2**64))
    out = []
    for _ in range(n):
        out.append(p)
        p = p + d
    return out


@pytest.fixture(scope="module")
def points():
    return _pts(171)


def _shards(mesh: Mesh, rows: np.ndarray) -> tuple:
    """[3, B, 30] rows as the sharded function's (xs, ys, zs): tuples of
    contiguous per-position [B/D, 30] tensors."""
    d = mesh.size
    blocks = rows.reshape(3, d, rows.shape[1] // d, G.NLIMBS)
    return tuple(
        tuple(torch.from_numpy(np.ascontiguousarray(blocks[c, i])) for i in range(d))
        for c in range(3)
    )


def _mod_q(rows) -> list[int]:
    return [G.limbs_to_int(r) * pow(G.R_MONT, -1, Q) % Q for r in rows]


@pytest.mark.parametrize("n", [8, 32])
def test_sharded_sum_equals_jax_mod_q(points, n):
    """Four virtual shards: the port's (X, Y, Z) equal JAX's as integers
    mod q, and both are the oracle's point."""
    mesh = Mesh([CPU] * 4)
    plain = np.zeros((3, n, G.NLIMBS), np.int32)
    plain[0] = G.ints_to_limbs_batch([p.x for p in points[:n]])
    plain[1] = G.ints_to_limbs_batch([p.y for p in points[:n]])
    plain[2, :, 0] = 1
    got = [c.numpy() for c in G.make_sharded_g1_aggregate(mesh)(*_shards(mesh, plain))]
    mont = np.stack([[G.to_mont_limbs(v) for v in (p.x, p.y, 1)] for p in points[:n]], axis=1)
    jax_fn = J.make_sharded_g1_aggregate(jax_default_mesh(4))
    want = [np.asarray(c).reshape(G.NLIMBS) for c in jax_fn(*(jnp.asarray(r) for r in mont))]
    assert _mod_q(got) == _mod_q(want)
    oracle = G1Point.sum(points[:n])
    assert G.projective_to_affine(*got) == oracle
    assert G.projective_to_affine(*want) == oracle


@pytest.mark.parametrize("m", [1, 2, 4])
def test_171_points_padded_over_the_mesh_equal_the_oracle(points, m):
    agg = G.G1Aggregator(mesh=Mesh([CPU] * m))
    assert agg._padded_size(171) == 512 and agg.device == CPU
    assert agg.aggregate(points) == G1Point.sum(points)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_padded_sizes_equal_jax(m):
    ours = G.G1Aggregator(mesh=Mesh([CPU] * m))
    theirs = J.TpuG1Aggregator(mesh=jax_default_mesh(m))
    for n in (1, 3, 8, 9, 31, 33, 171, 600):
        assert ours._padded_size(n) == theirs._padded_size(n), n


@pytest.mark.parametrize("mesh, match", [
    (Mesh([CPU] * 3), "power-of-two mesh, got 3 devices"),
    (Mesh([CPU] * 2, axis_names=("x",)), f"1-D \\('{DP_AXIS}',\\) mesh"),
], ids=["three-devices", "wrong-axis"])
def test_the_sharded_sum_refuses_a_mesh_it_cannot_combine(mesh, match):
    """``make_sharded_g1_aggregate`` itself checks the mesh: B4's tree
    takes a power-of-two count of partials, over the ``dp`` axis."""
    with pytest.raises(ValueError, match=match):
        G.make_sharded_g1_aggregate(mesh)


def test_construction_checks():
    with pytest.raises(ValueError, match="power-of-two mesh, got 3 devices"):
        G.G1Aggregator(mesh=Mesh([CPU] * 3))
    with pytest.raises(ValueError, match=f"1-D \\('{DP_AXIS}',\\) mesh"):
        G.G1Aggregator(mesh=Mesh([CPU] * 2, axis_names=("x",)))
    assert G.G1Aggregator(mesh=Mesh([CPU] * 2)).aggregate([G1Point.identity()]).inf


def test_the_sharded_bls_verifier(points):
    """``BlsVerifier(aggregator="cuda-sharded")`` (a CPU mesh here):
    named as the JAX one with ``cuda``, sums a QC's signatures on the
    mesh and rejects a swapped signature; the JAX names raise."""
    v = make_device_verifier("bls", "cuda-sharded", device="cpu")
    assert v.name == "bls-cuda-sharded" and v._dev_agg._sharded is not None
    assert v._dev_agg.mesh.size == 1 and v._dev_agg.mesh.devices == (CPU,)
    msg = b"\x4d" * 32
    pairs = [tbls.keygen(bytes([60 + i])) for i in range(3)]
    votes = [(pk.to_bytes(), sk.sign(msg).to_bytes()) for pk, sk in pairs]
    assert v.verify_shared_msg(msg, votes)
    assert not v.verify_shared_msg(msg, votes[:2] + [(votes[2][0], votes[0][1])])
    for name in ("tpu", "tpu-sharded"):
        with pytest.raises(ValueError, match="cuda"):
            BlsVerifier(aggregator=name, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BlsVerifier(aggregator="cuda-sharded")


@pytest.mark.cuda
def test_cuda_sharded_sum_over_four_shards_of_one_card(points):
    """On a card: B4 on four shards of cuda:0 and once more on the
    partials, against the oracle and the single-device aggregator."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    dev = torch.device("cuda", 0)
    G.reset_launches()
    sharded = G.G1Aggregator(mesh=Mesh([dev] * 4)).aggregate(points)
    assert G.launches["g1_aggregate"] == 5
    assert sharded == G1Point.sum(points) == G.G1Aggregator(device=dev).aggregate(points)
