"""IVC over the Pasta cycle (folding/ivc.py) on the CPU, against the JAX
package's, at the inputs of tests/test_ivc.py:
  - the verifier circuit's size, the uniform constraint set (at seeded
    cell values) and the fixed template of both sides equal the JAX
    package's;
  - a step trace (columns, z_out, digest) equals the JAX package's and its
    digest a host rate-2 3_60_0_5_5 sponge;
  - the reduced IVC (n = 32, two absorbs, three steps over Vesta / Fp,
    Pallas / Fq, Vesta / Fp, TestRng(5)): after every step, each side's
    accumulator (columns, error column, u, alphas, commitments, blinders)
    and kappa, and the digests, equal the JAX package's; both accumulators
    stay satisfied, open their commitments and pin their fixed columns, and
    a changed witness cell breaks the relation.
The decider proofs of the full circuit (n = 256) are the vectors of
tests/test_torch_column_vectors.py, held on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import random

import pytest
import torch

from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.fields import Fq as JFq
from proof_systems_tpu.folding import ivc as jivc
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poseidon import params as jparams
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch.circuits import expr as E
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.folding import ivc
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.poseidon import params
from proof_systems_tpu_torch.poseidon.permutation import poseidon_block_cipher_py
from proof_systems_tpu_torch.utils import TestRng

# The plain versions' curve arithmetic of the commits dominates; two threads halve
# it, and a test process per core would oversubscribe the machine at more
torch.set_num_threads(2)

CPU = torch.device("cpu")
SIDES = [(Fp, params.fp_3_60_0_5_5, JFp, jparams.fp_3_60_0_5_5),
         (Fq, params.fq_3_60_0_5_5, JFq, jparams.fq_3_60_0_5_5)]


def test_circuit_size_matches_reference():
    assert ivc.VERIFIER_CIRCUIT_SIZE == jivc.VERIFIER_CIRCUIT_SIZE == 196
    assert [ivc.verifier_circuit_size(k) for k in (1, 2, 15)] == [
        jivc.verifier_circuit_size(k) for k in (1, 2, 15)]


@pytest.mark.parametrize("side", [0, 1], ids=["fp", "fq"])
def test_constraints_and_template_equal_jax(side):
    f, prm, jf, jprm = SIDES[side]
    cons, jcons = ivc.ivc_constraints(f, prm), jivc.ivc_constraints(jf, jprm)
    assert len(cons) == len(jcons) == 19
    rng = random.Random(98 + side)
    cur = [rng.randrange(f.p) for _ in range(ivc.NCOLS)]
    nxt = [rng.randrange(f.p) for _ in range(ivc.NCOLS)]
    kw = dict(get_cell=lambda c, row: cur[c] if row == E.CURR else nxt[c], challenges={},
              endo=0, mds=[], point=0, domain_n=256, omega=1, zk_rows=0)
    assert [E.eval_host(c, E.HostEvalContext(f=f, **kw)) for c in cons] == [
        JE.eval_host(c, JE.HostEvalContext(f=jf, **kw)) for c in jcons]
    assert ivc._fixed_template(prm, 256) == jivc._fixed_template(jprm, 256)
    assert ivc._fixed_template(prm, 32, 2) == jivc._fixed_template(jprm, 32, 2)


def test_step_trace_equals_jax_and_host_sponge():
    absorbed = [(7 * i + 1) for i in range(8)]  # 4 blocks
    got = ivc.build_step_trace(Fp, params.fp_3_60_0_5_5, 5, absorbed, 64)
    assert got == jivc.build_step_trace(JFp, jparams.fp_3_60_0_5_5, 5, absorbed, 64)
    assert got[1] == 25
    state = [0, 0, 0]
    for b in range(4):
        state[1] = (state[1] + absorbed[2 * b]) % Fp.p
        state[2] = (state[2] + absorbed[2 * b + 1]) % Fp.p
        poseidon_block_cipher_py(params.fp_3_60_0_5_5, state)
    assert got[2] == state[0]


def side_state(s):
    acc = s.acc
    return (s.kappa, acc.columns, acc.error, acc.u, acc.alphas, acc.comms, acc.error_comm,
            acc.blinders, acc.error_blinder)


def test_reduced_ivc_equals_jax_step_by_step():
    n = 32
    port = ivc.IVC(*(SRS(c, [derive_g(c, i) for i in range(n)], derive_h(c), CPU)
                     for c in (Vesta, Pallas)), n=n, rng=TestRng(5), n_absorbs=2)
    jax = jivc.IVC(*(jsrs.SRS(c, [jsrs.derive_g(c, i) for i in range(n)], jsrs.derive_h(c))
                     for c in (JVesta, JPallas)), n=n, rng=JTestRng(5), n_absorbs=2)
    z = jz = 3
    for i in range(3):
        z, digest = port.step(i, z)
        jz, jdigest = jax.step(i, jz)
        assert (z, digest) == (jz, jdigest)
        for s, js in zip(port.sides, jax.sides):
            assert (s.acc is None) == (js.acc is None)
            if s.acc is not None:
                assert side_state(s) == side_state(js), (i, s.field.name)
    assert z == pow(3, 8, Fq.p) and port.digests == jax.digests
    for side in port.sides:
        assert side.env.is_satisfied(side.acc)
        assert side.scheme.check_commitments(side.acc)
        assert port.check_fixed_pinning(side)
    side = port.sides[0]
    side.acc.columns[0][0] = (side.acc.columns[0][0] + 1) % side.field.p
    assert not side.env.is_satisfied(side.acc)
