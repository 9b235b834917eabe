"""LogUp (o1vm/logup.py) on the CPU, where the plain versions of the
kernels run, against the JAX package's.
  - tests/test_logup.py's inputs: multiplicities and phi (random.Random(70),
    n = 16, two lookups a row into range_table(4, 16)) equal the JAX
    package's, and both refuse a corrupted multiplicity, a value that is not
    in the table and a denominator of 0; the port's batched inverses equal
    pow's; the LogupInstance of random.Random(71) is proved once
    by each package (TestRng(72)) and every ColumnProof field is equal.
  - A MultiLogup with bitwise_table(1, bits=2) (64 rows, so n = 64, the
    smallest domain that holds it) and the joint combiner over four trace
    columns of random.Random(74): phase 1, phase2_host and the proof equal
    the JAX package's field for field.
Each package's verifier accepts the other's proofs, and a changed
evaluation is rejected."""

import random

import pytest
import torch

from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.circuits.domains import EvaluationDomains as JEvaluationDomains
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.o1vm import logup as jlogup
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
from proof_systems_tpu_torch.o1vm import logup, pickles
from proof_systems_tpu_torch.ops import limb
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.utils.rng import TestRng

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

P = Fp.p
CPU = torch.device("cpu")
JCLASSES = (jpickles.ColumnProof, JPolyComm, JOpeningProof)
MULTI_N, TRACE_COLS = 64, 4


def test_multiplicities_and_phi_equal_jax():
    rng = random.Random(70)
    n = 16
    table = logup.range_table(4, n)
    assert table == jlogup.range_table(4, n)
    lookups = [[rng.randrange(16), rng.randrange(16)] for _ in range(n)]
    m = logup.multiplicities(lookups, table, P)
    assert m == jlogup.multiplicities(lookups, table, P) and sum(m) == 2 * n
    beta = rng.randrange(1, P)
    phi = logup.phi_column(lookups, table, m, beta, P)
    assert phi == jlogup.phi_column(lookups, table, m, beta, P) and phi[0] == 0


def test_inverses_equal_pow_and_a_zero_raises_in_both():
    """logup.inverses (the port's batch of a column's inverses) is pow(v, -1,
    p) element by element; a denominator of 0 (beta = -v) raises ValueError
    in phi_column in both packages."""
    rng = random.Random(75)
    vals = [rng.randrange(1, P) for _ in range(200)] + [1, P - 1]
    assert logup.inverses(vals, P) == [pow(v, -1, P) for v in vals]
    assert logup.inverses([], P) == []
    table = logup.range_table(4, 16)
    lookups = [[i % 16] for i in range(16)]
    m = logup.multiplicities(lookups, table, P)
    for mod in (logup, jlogup):
        with pytest.raises(ValueError, match="not invertible"):
            mod.phi_column(lookups, table, m, P - 5, P)


def test_corrupt_witness_raises():
    n = 16
    table = logup.range_table(4, n)
    lookups = [[i % 16] for i in range(n)]
    m = logup.multiplicities(lookups, table, P)
    m[3] += 1
    for mod in (logup, jlogup):
        with pytest.raises(ValueError, match="does not hold"):
            mod.phi_column(lookups, table, m, 12345, P)
        with pytest.raises(ValueError, match="not in table"):
            mod.multiplicities([[77]], table, P)


def bitwise_trace():
    """MULTI_N rows (op, x, y, op(x, y)) of bitwise_table(1, bits=2)."""
    rng = random.Random(74)
    fns = (lambda a, b: a & b, lambda a, b: a | b, lambda a, b: a ^ b,
           lambda a, b: 3 - (a | b))
    rows = []
    for _ in range(MULTI_N):
        op, x, y = rng.randrange(4), rng.randrange(4), rng.randrange(4)
        rows.append((op, x, y, fns[op](x, y)))
    return [[r[j] for r in rows] for j in range(TRACE_COLS)]


def multilogup(mod, emod, f):
    spec = mod.LookupSpec(1, emod.Literal(1),
                          [emod.Cell(pickles.col(j), emod.CURR) for j in range(TRACE_COLS)])
    return mod.MultiLogup(f, [spec], [mod.bitwise_table(1, bits=2)], MULTI_N, TRACE_COLS)


def _setup(n):
    g, h = [derive_g(Vesta, i) for i in range(n)], derive_h(Vesta)
    return (EvaluationDomains.create(Fp, n, device=CPU), SRS(Vesta, g, h, CPU),
            JEvaluationDomains.create(JFp, n), jsrs.SRS(JVesta, g, h))


@pytest.fixture(scope="module")
def proved():
    F, JF = limb.device_field(Fp), jlimb.device_field(JFp)
    out = {}

    # tests/test_logup.py's LogupInstance
    rng = random.Random(71)
    n = 16
    table = logup.range_table(4, n)
    lookups = [[rng.randrange(16), rng.randrange(16)] for _ in range(n)]
    inst, jinst = logup.LogupInstance(Fp, lookups, table), jlogup.LogupInstance(JFp, lookups, table)
    domain, srs, jdomain, jsrs_ = _setup(n)
    out["instance"] = dict(
        proof=inst.prove(domain, srs, Vesta, TestRng(72), device=CPU),
        jproof=jinst.prove(jdomain, jsrs_, JVesta, JTestRng(72)),
        verify=lambda proof, r, d=domain, s=srs: inst.verify(d, s, Vesta, proof, r),
        jverify=lambda proof, r, d=jdomain, s=jsrs_: jinst.verify(d, s, JVesta, proof, r))

    # a MultiLogup over the 2-bit bitwise table with the joint combiner
    cols = bitwise_trace()
    ml, jml = multilogup(logup, E, Fp), multilogup(jlogup, JE, JFp)
    phase1, jphase1 = ml.phase1_columns(cols), jml.phase1_columns(cols)
    domain, srs, jdomain, jsrs_ = _setup(MULTI_N)
    flat = [v for c in phase1 for v in c]
    proof = pickles.prove_columns(
        domain, srs, Vesta, F.pack_mont(flat, shape=(len(phase1), MULTI_N), device=CPU),
        ml.constraints(), TestRng(75), make_beta_columns=ml.make_phase2(F, CPU),
        with_joint_combiner=True, device=CPU)
    jproof = jpickles.prove_columns(
        jdomain, jsrs_, JVesta, JF.pack_mont(flat, shape=(len(phase1), MULTI_N)),
        jml.constraints(), JTestRng(75), make_beta_columns=jml.make_phase2(JF),
        with_joint_combiner=True)
    kw = dict(num_beta_columns=ml.num_phase2, with_joint_combiner=True)
    out["multi"] = dict(
        proof=proof, jproof=jproof, ml=ml, jml=jml, phase1=phase1, jphase1=jphase1,
        setup=(domain, srs, jdomain, jsrs_),
        verify=lambda p, r: pickles.verify_columns(domain, srs, Vesta, ml.constraints(), p, r,
                                                   **kw),
        jverify=lambda p, r: jpickles.verify_columns(jdomain, jsrs_, JVesta, jml.constraints(),
                                                     p, r, **kw))
    return out


CASES = ("instance", "multi")


@pytest.mark.parametrize("case", CASES)
def test_proof_fields_equal_jax(proved, case):
    got = column_proof_fields(proved[case]["proof"])
    want = column_proof_fields(proved[case]["jproof"])
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("case", CASES)
def test_each_verifier_accepts_the_others_proof(proved, case):
    c = proved[case]
    jproof = column_proof_from_fields(column_proof_fields(c["proof"]), JCLASSES)
    assert c["jverify"](jproof, JTestRng(73))
    assert c["verify"](column_proof_from_fields(column_proof_fields(c["jproof"])), TestRng(73))


@pytest.mark.parametrize("case", CASES)
def test_changed_evaluation_rejected(proved, case):
    fields = column_proof_fields(proved[case]["proof"])
    fields["zeta_evaluations"][0] = (fields["zeta_evaluations"][0] + 1) % P
    assert not proved[case]["verify"](column_proof_from_fields(fields), TestRng(76))
    assert not proved[case]["jverify"](column_proof_from_fields(fields, JCLASSES), JTestRng(76))


def test_multilogup_layout_and_phase2_equal_jax(proved):
    c = proved["multi"]
    ml, jml = c["ml"], c["jml"]
    assert c["phase1"] == c["jphase1"]
    assert (ml.table_col, ml.m_col, ml.h_cols, ml.phi_col, ml.num_phase2) == (
        jml.table_col, jml.m_col, jml.h_cols, jml.phi_col, jml.num_phase2)
    rng = random.Random(77)
    beta, joint = rng.randrange(P), rng.randrange(P)
    cols2 = ml.phase2_host(beta, joint)
    assert cols2 == jml.phase2_host(beta, joint)
    assert len(cols2) == ml.num_phase2 and cols2[-1][0] == 0


def test_multilogup_refuses_value_not_in_table():
    cols = bitwise_trace()
    cols[3][5] = (cols[3][5] + 1) % 4  # (op, x, y) has one z in the table
    for mod, emod, f in ((logup, E, Fp), (jlogup, JE, JFp)):
        with pytest.raises(ValueError, match="not in table"):
            multilogup(mod, emod, f).phase1_columns(cols)


def test_tables_pinned(proved):
    """verify_tables recommits the bitwise table and finds it in the proof,
    in both packages."""
    c = proved["multi"]
    domain, srs, jdomain, jsrs_ = c["setup"]
    assert c["ml"].verify_tables(domain, srs, c["proof"])
    assert c["jml"].verify_tables(jdomain, jsrs_,
                                  column_proof_from_fields(column_proof_fields(c["proof"]),
                                                           JCLASSES))
