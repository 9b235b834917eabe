"""Arrabbiata folding (folding/arrabbiata.py, folding/cli.py) on the CPU,
against the JAX package's, at the inputs of tests/test_folding.py:
  - fresh instances, folds and their relaxed relation (random.Random(60)):
    columns, error column, u and the alpha vector equal;
  - committed folding over an 8-point Vesta SRS (TestRng(61)): blinders,
    commitments, the cross-term commitments, the challenge r and the folded
    commitments equal (the port commits an instance's columns in one
    batched MSM, the JAX package one host MSM a column);
  - the decider at n = 16 (random.Random(62), TestRng(63)): the port's
    proof on the CPU equals the JAX package's field by field, and each
    package's verifier accepts the other's proof;
The IVC over both curves is in tests/test_torch_ivc.py, the CLI in
tests/test_torch_folding_cli.py."""

import random

import torch

from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.circuits.domains import EvaluationDomains as JEvaluationDomains
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.folding import arrabbiata as ja
from proof_systems_tpu.o1vm import pickles as jpickles
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poly_commitment.commitment import PolyComm as JPolyComm
from proof_systems_tpu.poly_commitment.ipa import OpeningProof as JOpeningProof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu.verifier_index import sponge_for as jsponge_for
from proof_systems_tpu_torch.circuits import expr as E
from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
from proof_systems_tpu_torch.convert import column_proof_fields, column_proof_from_fields
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.folding import arrabbiata as a
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.utils import TestRng
from proof_systems_tpu_torch.verifier_index import sponge_for
from tests import test_folding as jt

# The plain versions' curve arithmetic of the commits and the decider dominates; two
# threads halve it, and a test process per core would oversubscribe the machine at more
torch.set_num_threads(2)

P = Fp.p
CPU = torch.device("cpu")
JCLASSES = (jpickles.ColumnProof, JPolyComm, JOpeningProof)


def app_constraints(ex):
    """tests/test_folding.py's app constraints in either package's
    expressions: c1 = c0^2, c2 = c1^2 * c0, next c0 = c2 + c0."""
    c0, c1, c2 = (ex.Cell(i, ex.CURR) for i in range(jt.NCOLS))
    return [c1 - c0 * c0, c2 - c1 * c1 * c0, ex.Cell(0, ex.NEXT) - (c2 + c0)]


def envs():
    """The port's FoldingEnv and the JAX package's over the same constraints."""
    return a.FoldingEnv(Fp, jt.NCOLS, app_constraints(E)), ja.FoldingEnv(
        JFp, jt.NCOLS, app_constraints(JE))


def state(inst):
    return (inst.columns, inst.error, inst.u, inst.alphas, inst.comms, inst.error_comm,
            inst.blinders, inst.error_blinder)


def srs_pair(n):
    return (SRS(Vesta, [derive_g(Vesta, i) for i in range(n)], derive_h(Vesta), CPU),
            jsrs.SRS(JVesta, [jsrs.derive_g(JVesta, i) for i in range(n)],
                     jsrs.derive_h(JVesta)))


def test_fresh_and_fold_equal_jax():
    out = []
    for env in envs():
        rng = random.Random(60)
        fresh = env.fresh(jt.app_trace(3, 8), alpha=12345)
        assert env.is_satisfied(fresh)
        i1 = env.fresh(jt.app_trace(3, 8), alpha=rng.randrange(1, P))
        i2 = env.fresh(jt.app_trace(7, 8), alpha=rng.randrange(1, P))
        folded = env.fold(i1, i2, rng.randrange(1, P))
        steps = [state(fresh), state(folded), env.cross_term_columns(i1, i2)]
        for x0 in (11, 13):
            nxt = env.fresh(jt.app_trace(x0, 8), alpha=rng.randrange(1, P))
            folded = env.fold(folded, nxt, rng.randrange(1, P))
            steps.append(state(folded))
        assert env.is_satisfied(folded)
        folded.columns[0][2] = (folded.columns[0][2] + 1) % P
        assert not env.is_satisfied(folded)
        out.append(steps)
    assert out[0] == out[1]


def test_committed_folding_equals_jax():
    (env, jenv), (srs, jsrs_) = envs(), srs_pair(8)
    out = []
    for e, scheme, rng in ((env, a.FoldingScheme(env, srs, Vesta, lambda: sponge_for(Vesta)),
                            TestRng(61)),
                           (jenv, ja.FoldingScheme(jenv, jsrs_, JVesta,
                                                   lambda: jsponge_for(JVesta)), JTestRng(61))):
        i1 = e.fresh(jt.app_trace(3, 8), alpha=rng.field(P))
        i2 = e.fresh(jt.app_trace(7, 8), alpha=rng.field(P))
        scheme.commit_instance(i1, rng)
        scheme.commit_instance(i2, rng)
        folded, r, ct_comms = scheme.fold_committed(i1, i2, rng)
        assert e.is_satisfied(folded) and scheme.check_commitments(folded)
        assert len(ct_comms) == e.max_degree + 1
        out.append((state(i1), state(i2), state(folded), r, ct_comms))
    assert out[0] == out[1]


def test_decider_proof_equals_jax_and_cross_verifies():
    (env, jenv), (srs, jsrs_) = envs(), srs_pair(16)
    insts = []
    for e in (env, jenv):
        rng = random.Random(62)
        i1 = e.fresh(jt.app_trace(3, 16), alpha=rng.randrange(1, P))
        i2 = e.fresh(jt.app_trace(7, 16), alpha=rng.randrange(1, P))
        insts.append(e.fold(i1, i2, rng.randrange(1, P)))
    domain = EvaluationDomains.create(Fp, 16, device=CPU)
    jdomain = JEvaluationDomains.create(JFp, 16)
    proof, cons = a.decider_prove(env, insts[0], domain, srs, Vesta, TestRng(63), device=CPU)
    jproof, jcons = ja.decider_prove(jenv, insts[1], jdomain, jsrs_, JVesta, JTestRng(63))
    assert len(cons) == len(jcons) == 1
    got, want = column_proof_fields(proof), column_proof_fields(jproof)
    for key in want:
        assert got[key] == want[key], key
    assert a.decider_verify(env, column_proof_from_fields(want), cons, domain, srs, Vesta,
                            TestRng(64))
    assert ja.decider_verify(jenv, column_proof_from_fields(got, JCLASSES), jcons, jdomain,
                             jsrs_, JVesta, JTestRng(64))
    bad = dict(got, zeta_evaluations=[(got["zeta_evaluations"][0] + 1) % P,
                                      *got["zeta_evaluations"][1:]])
    assert not a.decider_verify(env, column_proof_from_fields(bad), cons, domain, srs, Vesta,
                                TestRng(65))
