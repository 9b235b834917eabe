"""o1vm's column prover (o1vm/pickles.py) on the CPU, where the plain
versions of the kernels run, against the JAX package's. The inputs of
tests/test_o1vm_pickles.py: a cyclic trace of n = 16 rows (c0 = w^i, c1
drawn from random.Random(50), c2 = c0 * c1) over the 16-point derived SRS,
TestRng(51). Two more proofs of that trace, each made once for the module:
  - "boundary": two UnnormalizedLagrangeBasis rows (0 and 5) pin c0 there,
    in a two-phase proof with the joint combiner whose beta column is
    beta + joint * c1;
  - "numerator": the same constraints through `quotient_numerator` (a
    hand-written evaluator over d8) on the port's side, against the JAX
    package's "boundary" proof (its AST walk).
In every case every ColumnProof field equals the JAX package's exactly,
each package's verify_columns accepts the other's proof, and a changed
evaluation is rejected. An unsatisfied trace raises "not satisfied" in
both, and the boundary rows' d8 values, the singular entry 8i included,
equal the JAX package's."""

import random

import numpy as np
import pytest
import torch

from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.circuits.domains import EvaluationDomains as JEvaluationDomains
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.o1vm import pickles as jpickles
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poly_commitment.commitment import PolyComm as JPolyComm
from proof_systems_tpu.poly_commitment.ipa import OpeningProof as JOpeningProof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch.circuits import expr as E
from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
from proof_systems_tpu_torch.convert import column_proof_fields, column_proof_from_fields
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.o1vm import pickles
from proof_systems_tpu_torch.ops import limb
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.utils.rng import TestRng

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

N = 16
CPU = torch.device("cpu")
CASES = ("pickles", "boundary", "numerator")
BOUNDARY_ROWS = (0, 5)
JCLASSES = (jpickles.ColumnProof, JPolyComm, JOpeningProof)


def trace():
    """tests/test_o1vm_pickles.py's columns: c0 = w^i, c1 random, c2 = c0 c1."""
    rng = random.Random(50)
    omega = EvaluationDomains.create(Fp, N, device=CPU).d1.group_gen
    c0 = [pow(omega, i, Fp.p) for i in range(N)]
    c1 = [rng.randrange(Fp.p) for _ in range(N)]
    return omega, [c0, c1, [a * b % Fp.p for a, b in zip(c0, c1)]]


def constraints(mod, case: str, omega: int):
    """The case's constraints over either package's expression module."""
    cell = lambda i, row=mod.CURR: mod.Cell(pickles.col(i), row)  # noqa: E731
    out = [cell(2) - cell(0) * cell(1), cell(0, mod.NEXT) - mod.Literal(omega) * cell(0)]
    if case != "pickles":
        out += [mod.UnnormalizedLagrangeBasis(r) * (cell(0) - mod.Literal(pow(omega, r, Fp.p)))
                for r in BOUNDARY_ROWS]
        out.append(cell(3) - (mod.Challenge("beta") + mod.Challenge("joint_combiner") * cell(1)))
    return out


def port_numerator(omega: int):
    """quotient_numerator for the "numerator" case: the combined constraint
    sum_k alpha^k c_k over d8, written with limb ops."""

    def numerator(evals8, ctx):
        F = ctx.F
        dev = evals8.device
        c0, c1, c2, c3 = (evals8[:, i] for i in range(4))
        const = lambda x: F.const_mont(x, (1,), device=dev)  # noqa: E731
        chal = {k: const(v) for k, v in ctx.challenges.items()}
        terms = [limb.sub(F, c2, limb.mont_mul(F, c0, c1)),
                 limb.sub(F, ctx.shifted(c0), limb.mont_mul(F, c0, const(omega)))]
        for r in BOUNDARY_ROWS:
            terms.append(limb.mont_mul(F, ctx.unnormalized_lagrange[r],
                                       limb.sub(F, c0, const(pow(omega, r, Fp.p)))))
        terms.append(limb.sub(F, c3, limb.add(F, chal["beta"],
                                              limb.mont_mul(F, chal["joint_combiner"], c1))))
        alpha = chal["alpha"]
        acc, scale = terms[0], alpha
        for t in terms[1:]:
            acc = limb.add(F, acc, limb.mont_mul(F, t, scale))
            scale = limb.mont_mul(F, scale, alpha)
        return acc

    return numerator


def beta_column(pack, c1):
    """The two-phase cases' beta column beta + joint * c1."""

    def build(beta, joint):
        return pack([(beta + joint * v) % Fp.p for v in c1])

    return build


@pytest.fixture(scope="module")
def proved():
    omega, cols = trace()
    g, h = [derive_g(Vesta, i) for i in range(N)], derive_h(Vesta)
    domain = EvaluationDomains.create(Fp, N, device=CPU)
    srs = SRS(Vesta, g, h, CPU)
    jdomain = JEvaluationDomains.create(JFp, N)
    jsrs_ = jsrs.SRS(JVesta, g, h)
    F, JF = limb.device_field(Fp), jlimb.device_field(JFp)
    flat = [v for c in cols for v in c]
    packed = F.pack_mont(flat, shape=(3, N), device=CPU)
    jpacked = JF.pack_mont(flat, shape=(3, N))
    out = dict(omega=omega, domain=domain, srs=srs, jdomain=jdomain, jsrs=jsrs_)
    for case in CASES:
        kw, jkw = {}, {}
        if case != "pickles":
            kw = dict(make_beta_columns=beta_column(
                lambda xs: F.pack_mont(xs, shape=(1, N), device=CPU), cols[1]),
                with_joint_combiner=True)
            jkw = dict(make_beta_columns=beta_column(
                lambda xs: JF.pack_mont(xs, shape=(1, N)), cols[1]),
                with_joint_combiner=True)
        if case == "numerator":
            kw["quotient_numerator"] = port_numerator(omega)
        proof = pickles.prove_columns(domain, srs, Vesta, packed, constraints(E, case, omega),
                                      TestRng(51), device=CPU, **kw)
        if case == "numerator":  # the JAX package's proof of the same constraints
            jproof = out["boundary"][1]
        else:
            jproof = jpickles.prove_columns(jdomain, jsrs_, JVesta, jpacked,
                                            constraints(JE, case, omega), JTestRng(51), **jkw)
        out[case] = (proof, jproof)
    return out


def _verify_kw(case):
    return {} if case == "pickles" else dict(num_beta_columns=1, with_joint_combiner=True)


@pytest.mark.parametrize("case", CASES)
def test_proof_fields_equal_jax(proved, case):
    proof, jproof = proved[case]
    got, want = column_proof_fields(proof), column_proof_fields(jproof)
    for key in want:
        assert got[key] == want[key], key
    assert len(got["opening"]["lr"]) == 4  # log2(16) rounds


@pytest.mark.parametrize("case", CASES)
def test_port_verifies_jax_proof(proved, case):
    fields = column_proof_fields(proved[case][1])
    assert pickles.verify_columns(proved["domain"], proved["srs"], Vesta,
                                  constraints(E, case, proved["omega"]),
                                  column_proof_from_fields(fields), TestRng(52),
                                  **_verify_kw(case))


@pytest.mark.parametrize("case", CASES)
def test_jax_verifies_port_proof(proved, case):
    fields = column_proof_fields(proved[case][0])
    jproof = column_proof_from_fields(fields, JCLASSES)
    assert jpickles.verify_columns(proved["jdomain"], proved["jsrs"], JVesta,
                                   constraints(JE, case, proved["omega"]), jproof,
                                   JTestRng(52), **_verify_kw(case))


@pytest.mark.parametrize("case", CASES)
def test_changed_evaluation_rejected(proved, case):
    fields = column_proof_fields(proved[case][0])
    fields["zeta_evaluations"][2] = (fields["zeta_evaluations"][2] + 1) % Fp.p
    omega = proved["omega"]
    assert not pickles.verify_columns(proved["domain"], proved["srs"], Vesta,
                                      constraints(E, case, omega),
                                      column_proof_from_fields(fields), TestRng(53),
                                      **_verify_kw(case))
    assert not jpickles.verify_columns(proved["jdomain"], proved["jsrs"], JVesta,
                                       constraints(JE, case, omega),
                                       column_proof_from_fields(fields, JCLASSES),
                                       JTestRng(53), **_verify_kw(case))


def test_boundary_rows_equal_jax(proved):
    """The d8 values of (x^n - 1)/(x - w^i) for rows 0 and 5, n * w^(-i) at
    the point 8i, against the JAX package's host values."""
    omega, d8 = proved["omega"], proved["domain"].d8
    F, JF = limb.device_field(Fp), jlimb.device_field(JFp)
    cons = constraints(E, "boundary", omega)
    got = pickles._unnormalized_lagrange_evals(F, cons, N, omega, d8, Fp.p, device=CPU)
    want = jpickles._unnormalized_lagrange_evals(
        JF, constraints(JE, "boundary", omega), N, omega, proved["jdomain"].d8, Fp.p)
    assert sorted(got) == sorted(want) == list(BOUNDARY_ROWS)
    for i in BOUNDARY_ROWS:
        vals = F.unpack_mont(got[i])
        assert vals == JF.unpack_mont(np.asarray(want[i]))
        assert vals[8 * i] == N * pow(omega, Fp.p - 1 - i, Fp.p) % Fp.p
        assert vals[8 * i + 1] != 0 and vals[8 * (i + 1) % (8 * N)] == 0


def test_unsatisfied_constraints_raise():
    """tests/test_o1vm_pickles.py's unsatisfied trace: c0 * c1 = 1 fails."""
    rng = random.Random(54)
    xs = [rng.randrange(Fp.p) for _ in range(2 * N)]
    g, h = [derive_g(Vesta, i) for i in range(N)], derive_h(Vesta)
    cons = lambda mod: [mod.Cell(pickles.col(0), mod.CURR) * mod.Cell(pickles.col(1), mod.CURR)  # noqa: E731
                        - mod.Literal(1)]
    F, JF = limb.device_field(Fp), jlimb.device_field(JFp)
    with pytest.raises(ValueError, match="not satisfied"):
        pickles.prove_columns(EvaluationDomains.create(Fp, N, device=CPU), SRS(Vesta, g, h, CPU),
                              Vesta, F.pack_mont(xs, shape=(2, N), device=CPU), cons(E),
                              TestRng(55), device=CPU)
    with pytest.raises(ValueError, match="not satisfied"):
        jpickles.prove_columns(JEvaluationDomains.create(JFp, N), jsrs.SRS(JVesta, g, h), JVesta,
                               JF.pack_mont(xs, shape=(2, N)), cons(JE), JTestRng(55))
