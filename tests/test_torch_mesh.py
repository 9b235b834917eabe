"""The port's multi-device layer (parallel/, the sharded MSM routes of
ops/msm.py, the row-sharded quotient of prover.py) on four gloo ranks of
the CPU, against the JAX package on the same inputs.

One module-scoped spawn of four ranks (tests/torch_mesh_ranks.py, which
imports no JAX) runs every statement; while the ranks work, this process
computes the JAX package's side. Each rank returns host values, and every
rank's must equal rank 0's, since collectives put the results back
together. Every comparison is exact:
  - DistNttPlan at log_n = 7, forward against the JAX package's
    ntt_plan(Fp, 7) and the inverse back to the input;
  - sharded_ntt_step(mesh, 4) against the JAX package's on a 4-device mesh
    of conftest.py's eight;
  - the batch-sharded (n = 16, b = 8, c = 6) and point-sharded (n = 64 on a
    scaled basis, n = 67 unscaled, padded to 68) MSMs through msm(), and
    sharded_msm_check(n = 32, b = 2), against the host MSM;
  - the fixed 2^5 proof, byte for byte tests/vectors/proof_2^5.bin;
  - _quotient_fn on tests/test_torch_prover.py's seeded inputs (the
    row-sharded walk with its wrapping halo) against the JAX package's.
The dry run over two ranks (parallel/dryrun.py) is heavy; a world of one
on the card is in tests/test_torch_cuda.py."""

import pathlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_mesh_ranks as R
from proof_systems_tpu import prover as jprover
from proof_systems_tpu.circuits.builders import bench_circuit as jbench_circuit
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.ops import ntt as jntt
from proof_systems_tpu.parallel.mesh import sharded_ntt_step as jsharded_ntt_step
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import limb
from proof_systems_tpu_torch.parallel import auto
from proof_systems_tpu_torch.parallel.spawn import Ranks

torch.set_num_threads(1)

WORLD = 4
FIXTURE = pathlib.Path(__file__).parent / "vectors" / "proof_2^5.bin"


def _jax_side() -> dict:
    """The JAX package's values for every statement of the ranks."""
    JF = jlimb.device_field(JFp)
    out = {}
    rng = random.Random(7)
    n = 1 << R.NTT_LOG_N
    x = JF.pack_mont([rng.randrange(JFp.p) for _ in range(n)], shape=(n,))
    out["ntt"] = JF.unpack_mont(jntt.ntt_plan(JFp, R.NTT_LOG_N).ntt(x))
    rng = random.Random(8)
    out["ntt_back"] = [rng.randrange(JFp.p) for _ in range(n)]

    back, total = jsharded_ntt_step(JMesh(jax.devices()[:WORLD], ("data",)), WORLD)
    out["step"] = (JF.unpack_mont(back), JF.unpack_mont(total))

    out["msm"] = {name: [JVesta.msm(row, pts) for row in rows]
                  for name, n, b, c, scaled, pts, rows in R.msm_cases()}
    rng = random.Random(5)
    pts = [JVesta.scalar_mul(rng.randrange(1, JVesta.scalar.p), JVesta.generator)
           for _ in range(32)]
    out["msm_check"] = [JVesta.msm([rng.randrange(JVesta.scalar.p) for _ in range(32)], pts)
                        for _ in range(2)]

    g = [jsrs.derive_g(JVesta, i) for i in range(R.N)]
    jcs = JConstraintSystem.create(JFp, jbench_circuit(JFp, R.GATES), public=0,
                                   max_poly_size=R.N)
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, jsrs.derive_h(JVesta)))
    w, z, vals = R.quotient_inputs("cpu")
    names = ("alpha", "beta", "gamma")
    jchal = {k: JF.pack_mont([v], shape=(1,)) for k, v in zip(names, vals)}
    jchal.update(joint_combiner=JF.pack_mont([0], shape=(1,)),
                 tid_comb=JF.pack_mont([0], shape=(1,)))
    public = limb.device_field(Fp).zeros((R.N,), device="cpu")
    qfn = jprover._quotient_fn(jindex)
    jq, jrem, _, jr1, jr2 = qfn(
        *(jnp.asarray(convert.limbs_to_numpy(t)) for t in (w, z, public)),
        jchal, None, jindex._qfn_consts)
    out["quotient"] = [np.asarray(t) for t in (jq, jrem, jr1, jr2)]
    return out


@pytest.fixture(scope="module")
def ranks():
    handle = Ranks(R.mesh_checks, WORLD, "cpu")  # the ranks run while JAX computes
    want = _jax_side()
    return handle.results(timeout=900), want


def test_every_rank_holds_the_same_values(ranks):
    outs, _ = ranks
    assert [o["rank"] for o in outs] == list(range(WORLD))
    assert all(o["size"] == WORLD for o in outs)
    for o in outs[1:]:
        for key in ("ntt", "ntt_back", "step", "msm", "msm_check", "proof"):
            assert o[key] == outs[0][key], key
        for a, b in zip(o["quotient"], outs[0]["quotient"], strict=True):
            assert np.array_equal(a, b)


def test_dist_ntt_forward_and_inverse(ranks):
    outs, want = ranks
    assert outs[0]["ntt"] == want["ntt"]
    assert outs[0]["ntt_back"] == want["ntt_back"]


def test_sharded_ntt_step_matches_jax(ranks):
    outs, want = ranks
    assert outs[0]["step"] == want["step"]


@pytest.mark.parametrize("case", ["batch", "point64", "point67"])
def test_sharded_msm_routes_match_host(ranks, case):
    outs, want = ranks
    assert outs[0]["msm"][case] == want["msm"][case]


def test_msm_took_both_routes_with_padding(ranks):
    outs, _ = ranks
    routes = outs[0]["msm_routes"]
    # b = 8 splits over 4 ranks; b = 2 does not, and n = 67 pads to 68
    assert routes["_batch_sharded_msm"] == 1
    assert routes["_point_sharded_msm"] == 2
    assert routes["_pad_points_for_shard"] == 1


def test_sharded_msm_check(ranks):
    outs, want = ranks
    assert outs[0]["msm_check"] == want["msm_check"]


def test_sharded_proof_equals_vector(ranks):
    outs, _ = ranks
    assert outs[0]["proof"] == FIXTURE.read_bytes()
    assert all(o["verifies"] for o in outs)
    routes = outs[0]["proof_routes"]
    assert routes.get("_point_sharded_msm", 0) > 0
    assert routes.get("all_gather", 0) == 1  # the quotient's t8


def test_row_sharded_quotient_matches_jax(ranks):
    outs, want = ranks
    assert outs[0]["quotient_gathers"] == 1
    for ours, theirs in zip(outs[0]["quotient"], want["quotient"], strict=True):
        assert torch.equal(convert.limbs_from_numpy(ours, device="cpu"),
                           convert.limbs_from_numpy(theirs, device="cpu"))


def test_no_mesh_without_a_group_or_with_pst_mesh_0(monkeypatch):
    auto.reset_mesh()
    assert auto.data_mesh() is None
    monkeypatch.setenv("PST_MESH", "0")
    assert auto.data_mesh() is None


@pytest.mark.heavy
def test_dryrun_multichip_two_cpu_ranks():
    from proof_systems_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    assert out["ranks"] == 2 and len(out["proof"]) > 0


def test_a_failing_rank_raises_in_results():
    with pytest.raises(Exception, match="rank 1 failed"):
        Ranks(R.failing, 2, "cpu").results(timeout=120)
