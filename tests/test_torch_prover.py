"""A whole proof on the CPU, where the plain versions of the kernels run: the
port proves the fixed 2^5 circuit (bench_circuit(22) over a 32-point SRS,
bench_witness(22), TestRng(5)) once for the module, and
  - its serialized bytes equal tests/vectors/proof_2^5.bin, which the JAX
    package's proof of the same circuit is held to;
  - the port's verifier accepts the port's deserialization of those bytes
    and rejects ft_eval1 + 1;
  - the JAX package's verifier accepts the JAX deserialization of them;
  - the verifier-index digest equals the JAX package's;
  - the quotient function (quotient, remainder, both boundary remainders)
    equals the JAX package's _quotient_fn on the same seeded inputs, so that
    a byte mismatch can be traced to its stage.
Every comparison is exact."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proof_systems_tpu import prover as jprover
from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits.builders import bench_circuit as jbench_circuit
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu.serialization import deserialize_proof as jdeserialize_proof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import limb
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.prover import _quotient_fn, create_proof
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_proof
from proof_systems_tpu_torch.utils.rng import TestRng
from proof_systems_tpu_torch.verifier import verify

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

FIXTURE = pathlib.Path(__file__).parent / "vectors" / "proof_2^5.bin"
N, GATES = 32, 22


@pytest.fixture(scope="module")
def proved():
    g = [derive_g(Vesta, i) for i in range(N)]
    h = derive_h(Vesta)
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, GATES), public=0, max_poly_size=N,
                                 device="cpu")
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    debug = {}
    proof = create_proof(index, bench_witness(GATES), TestRng(5), debug=debug)
    jcs = JConstraintSystem.create(JFp, jbench_circuit(JFp, GATES), public=0, max_poly_size=N)
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    return dict(index=index, jindex=jindex, proof=proof, debug=debug,
                raw=serialize_proof(Vesta, proof))


def test_proof_bytes_equal_fixture(proved):
    assert proved["raw"] == FIXTURE.read_bytes()
    assert proved["debug"]["quotient_rem_zero"]


def test_port_verifier_accepts_and_rejects(proved):
    vk = proved["index"].verifier_index()
    proof = deserialize_proof(Vesta, proved["raw"])
    assert verify(vk, proof, [], TestRng(6))
    proof.ft_eval1 = (proof.ft_eval1 + 1) % Fp.p
    assert not verify(vk, proof, [], TestRng(8))


def test_jax_verifier_accepts_port_bytes(proved):
    proof = jdeserialize_proof(JVesta, proved["raw"])
    assert jverifier.verify(proved["jindex"].verifier_index(), proof, [], JTestRng(6))


def test_verifier_index_digest_matches_jax(proved):
    assert proved["index"].verifier_index().digest() == proved["jindex"].verifier_index().digest()


def test_quotient_matches_jax(proved):
    """The quotient phase on seeded random witness and z coefficients and
    challenges, against the JAX package's _quotient_fn (its op-by-op CPU
    form): quotient, remainder and the boundary remainders r1, r2."""
    index, jindex = proved["index"], proved["jindex"]
    rng = np.random.default_rng(33)
    F = limb.device_field(Fp)
    w = F.pack_mont([int(v) for v in rng.integers(0, 1 << 62, 15 * N)], shape=(15, N),
                    device="cpu")
    z = F.pack_mont([int(v) for v in rng.integers(0, 1 << 62, N)], shape=(N,), device="cpu")
    public = F.zeros((N,), device="cpu")
    names = ("alpha", "beta", "gamma")
    vals = [int(v) for v in rng.integers(0, 1 << 62, 3)]
    chal = {k: F.pack_mont([v], shape=(1,), device="cpu") for k, v in zip(names, vals)}
    q, rem, jt_coeff, r1, r2 = _quotient_fn(index)(w, z, public, chal)
    assert jt_coeff is None  # no lookups: no combined table

    JF = jlimb.device_field(JFp)
    jchal = {k: JF.pack_mont([v], shape=(1,)) for k, v in zip(names, vals)}
    jchal.update(joint_combiner=JF.pack_mont([0], shape=(1,)), tid_comb=JF.pack_mont([0], shape=(1,)))
    qfn = jprover._quotient_fn(jindex)
    jq, jrem, _, jr1, jr2 = qfn(*(jnp.asarray(convert.limbs_to_numpy(t)) for t in (w, z, public)),
                                jchal, None, jindex._qfn_consts)
    for ours, theirs in zip((q, rem, r1, r2), (jq, jrem, jr1, jr2), strict=True):
        assert torch.equal(ours, convert.limbs_from_numpy(np.asarray(theirs), device="cpu"))
