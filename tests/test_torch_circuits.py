"""The port's circuit layer on the CPU against the JAX package, for the bench
circuit at n = 32 and n = 64: the constraint system (domain, zk rows,
shifts, sid, sigma, selectors, coefficients), the alpha registry, the
linearization evaluated on the host at seeded random cells, the same
linearization walked over device columns (eval_dev) against the host walk,
and the prover index's column data, coefficient and d8 forms, limb for limb.
Every comparison is exact."""

import random

import numpy as np
import pytest
import torch

from proof_systems_tpu.circuits import expr as jexpr
from proof_systems_tpu.circuits.builders import bench_circuit as jbench_circuit
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poseidon import fp_kimchi as jfp_kimchi
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.circuits import expr
from proof_systems_tpu_torch.circuits.builders import bench_circuit
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.circuits.gate import CircuitGate, GateType, new_wires
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import limb
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.poseidon import fp_kimchi
from proof_systems_tpu_torch.prover_index import ALWAYS_ON, ProverIndex

torch.set_num_threads(1)

GATES = {32: 22, 64: 50}  # bench gates per domain size


@pytest.fixture(scope="module", params=[32, 64], ids=["n=32", "n=64"])
def pair(request):
    """The port's and the JAX package's prover index of the bench circuit."""
    n = request.param
    g = [derive_g(Vesta, i) for i in range(n)]
    h = derive_h(Vesta)
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, GATES[n]), public=0, max_poly_size=n,
                                 device="cpu")
    jcs = JConstraintSystem.create(JFp, jbench_circuit(JFp, GATES[n]), public=0, max_poly_size=n)
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    return n, index, jindex


def test_constraint_system_matches_jax(pair):
    n, index, jindex = pair
    cs, jcs = index.cs, jindex.cs
    assert cs.domain.d1.n == jcs.domain.d1.n == n
    assert cs.domain.d8.n == jcs.domain.d8.n == 8 * n
    assert cs.domain.d1.group_gen == jcs.domain.d1.group_gen
    assert cs.domain.d8.group_gen == jcs.domain.d8.group_gen
    assert cs.zk_rows == jcs.zk_rows
    assert cs.shift == jcs.shift
    assert cs.sid == jcs.sid
    assert cs.sigma_d1 == jcs.sigma_d1
    assert cs.coefficients_d1 == jcs.coefficients_d1
    assert {int(g): v for g, v in cs.selectors_d1.items()} == {
        int(g): v for g, v in jcs.selectors_d1.items()
    }
    assert cs.endo == jcs.endo
    assert cs.eval_zkpm(12345) == jcs.eval_zkpm(12345)


def test_alphas_match_jax(pair):
    _, index, jindex = pair
    for kind, count in (("gate", 21), ("permutation", 3)):
        assert index.alphas.get_exponents(kind, count) == jindex.alphas.get_exponents(kind, count)


def _random_cells(seed: int):
    rng = random.Random(seed)
    cols = [expr.col_witness(i) for i in range(15)] + [expr.col_coeff(i) for i in range(15)]
    cols += [expr.COL_Z] + [expr.col_index(g) for g in ALWAYS_ON]
    return {(c, row): rng.randrange(Fp.p) for c in cols for row in (expr.CURR, expr.NEXT)}


def test_linearization_host_eval_matches_jax(pair):
    """The constant term of the linearization at zeta, on seeded random
    cells and challenges, equals the JAX package's walk of its own AST."""
    n, index, jindex = pair
    cells = _random_cells(n)
    rng = random.Random(n + 1)
    chal = {k: rng.randrange(Fp.p) for k in ("alpha", "beta", "gamma", "joint_combiner")}
    kw = dict(challenges=chal, endo=index.cs.endo, point=rng.randrange(Fp.p), domain_n=n,
              omega=index.cs.domain.d1.group_gen, zk_rows=index.cs.zk_rows)
    got = expr.eval_host(index.linearization_expr, expr.HostEvalContext(
        f=Fp, get_cell=lambda c, r: cells[(c, r)], mds=[list(r) for r in fp_kimchi.mds], **kw))
    want = jexpr.eval_host(jindex.linearization_expr, jexpr.HostEvalContext(
        f=JFp, get_cell=lambda c, r: cells[(c, r)], mds=[list(r) for r in jfp_kimchi.mds], **kw))
    assert got == want


def test_linearization_eval_dev_matches_host_walk():
    """eval_dev over 16-point columns (NEXT = 8 positions on) equals
    eval_host at every position; nodes are released after their last use."""
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, 22), public=0, max_poly_size=32,
                                 device="cpu")
    index = ProverIndex(cs, Vesta, SRS(Vesta, [derive_g(Vesta, i) for i in range(32)],
                                       derive_h(Vesta), torch.device("cpu")))
    F = limb.device_field(Fp)
    rng = random.Random(5)
    m = 16
    cols = {c: [rng.randrange(Fp.p) for _ in range(m)] for c, _ in _random_cells(0)}
    alpha = rng.randrange(Fp.p)
    ctx = expr.DeviceEvalContext(
        F=F, columns={c: F.pack_mont(v, device="cpu") for c, v in cols.items()},
        challenges={"alpha": F.pack_mont([alpha], device="cpu")}, endo=cs.endo,
        mds=[list(r) for r in fp_kimchi.mds], domain_n=32, zk_rows=cs.zk_rows,
        omega=cs.domain.d1.group_gen)
    memo = {}
    got = F.unpack_mont(expr.eval_dev(index.linearization_expr, ctx, memo))
    assert memo == {}
    for j in range(m):
        host = expr.eval_host(index.linearization_expr, expr.HostEvalContext(
            f=Fp, get_cell=lambda c, r: cols[c][(j + 8 * r) % m], challenges={"alpha": alpha},
            endo=cs.endo, mds=[list(r) for r in fp_kimchi.mds], point=0, domain_n=32,
            omega=cs.domain.d1.group_gen, zk_rows=cs.zk_rows))
        assert got[j] == host, j


def test_prover_index_columns_match_jax(pair):
    _, index, jindex = pair
    cd, jcd = index.column_data, jindex.column_data
    for name in ("sigma_coeff", "sigma8", "coefficients_coeff", "coefficients8", "zkpl8",
                 "vanishes_zk_prev8", "x_d8"):
        assert torch.equal(getattr(cd, name), convert.limbs_from_numpy(getattr(jcd, name), device="cpu")), name
    for attr in ("selector_coeff", "selector8"):
        ours, theirs = getattr(cd, attr), getattr(jcd, attr)
        assert [int(g) for g in ours] == [int(g) for g in theirs]
        for g in ours:
            assert torch.equal(ours[g], convert.limbs_from_numpy(np.asarray(theirs[g]), device="cpu")), (attr, g)


def test_unported_gates_are_refused():
    """No gate is refused any more: an Xor16 circuit gets its feature flag,
    its selector (set on its row only) and the Xor lookup pattern into the
    XOR table; a Lookup circuit gets its lookup constraint system and no
    feature flag."""
    gates = bench_circuit(Fp, 4) + [CircuitGate(GateType.Xor16, new_wires(4), [])]
    cs = ConstraintSystem.create(Fp, gates, device="cpu")
    assert cs.feature_flags == {GateType.Xor16}
    assert [r for r, v in enumerate(cs.selectors_d1[GateType.Xor16]) if v] == [4]
    assert [p.value for p in cs.lookup_cs.info.patterns] == ["xor"]
    assert cs.lookup_cs.table_ids is None and cs.domain.d1.n == 512
    gates = bench_circuit(Fp, 4) + [CircuitGate(GateType.Lookup, new_wires(4), [])]
    cs = ConstraintSystem.create(Fp, gates, device="cpu")
    assert cs.lookup_cs is not None and not cs.feature_flags
    assert set(cs.selectors_d1) == set(ALWAYS_ON)
