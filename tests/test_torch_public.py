"""Public inputs end to end on the CPU, where the plain versions of the
kernels run. The circuit of tests/test_gates_e2e.py
(test_nonzero_public_input_prove): 2 public generic gates, then 10 Const(1)
gates, max_poly_size 32, public values [13, 29], TestRng(114). The port and
the JAX package each prove it once for the module, and
  - the port's proof bytes equal the JAX package's;
  - the port's verifier accepts [13, 29] and rejects [13, 30];
  - the JAX package's verifier accepts the port's bytes;
  - to_batch's public commitment and oracles' public evaluations equal the
    JAX package's, for the true and the changed public input.
Every comparison is exact."""

import pytest
import torch

from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits.builders import GenericGateSpec as JGenericGateSpec
from proof_systems_tpu.circuits.builders import create_generic_gadget as jcreate_generic_gadget
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.prover import create_proof as jcreate_proof
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu.serialization import deserialize_proof as jdeserialize_proof
from proof_systems_tpu.serialization import serialize_proof as jserialize_proof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch import verifier
from proof_systems_tpu_torch.circuits.builders import GenericGateSpec, create_generic_gadget
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.prover import create_proof
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_proof
from proof_systems_tpu_torch.utils.rng import TestRng

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

PUBLIC = [13, 29]
CHANGED = [13, 30]
MAX_POLY_SIZE = 32
SEED = 114


def circuit(f, spec, gadget):
    return [gadget(f, r, spec.pub(f)) for r in range(len(PUBLIC))] + [
        gadget(f, len(PUBLIC) + r, spec.const(f, 1)) for r in range(10)
    ]


def witness(n: int, zk_rows: int) -> list[list[int]]:
    w = [[0] * (n - zk_rows) for _ in range(15)]
    w[0][: len(PUBLIC)] = PUBLIC
    for r in range(len(PUBLIC), len(PUBLIC) + 10):
        w[0][r] = 1
    return w


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    cs = ConstraintSystem.create(Fp, circuit(Fp, GenericGateSpec, create_generic_gadget),
                                 public=len(PUBLIC), max_poly_size=MAX_POLY_SIZE, device="cpu")
    n = cs.domain.d1.n
    g, h = [derive_g(Vesta, i) for i in range(n)], derive_h(Vesta)
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    proof = create_proof(index, witness(n, cs.zk_rows), TestRng(SEED))

    # the JAX SRS caches its Lagrange commitments on disk: keep them here
    saved, jsrs.CACHE_DIR = jsrs.CACHE_DIR, tmp_path_factory.mktemp("jax_lagrange")
    jcs = JConstraintSystem.create(
        JFp, circuit(JFp, JGenericGateSpec, jcreate_generic_gadget),
        public=len(PUBLIC), max_poly_size=MAX_POLY_SIZE)
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    jproof = jcreate_proof(jindex, witness(n, jcs.zk_rows), JTestRng(SEED))
    yield dict(index=index, jindex=jindex, proof=proof, jproof=jproof,
               raw=serialize_proof(Vesta, proof), jraw=jserialize_proof(JVesta, jproof))
    jsrs.CACHE_DIR = saved


def test_proof_bytes_equal_jax(proved):
    assert proved["raw"] == proved["jraw"]


def test_port_verifier_accepts_and_rejects(proved):
    vk = proved["index"].verifier_index()
    proof = deserialize_proof(Vesta, proved["raw"])
    assert verifier.verify(vk, proof, PUBLIC, TestRng(SEED + 1))
    assert not verifier.verify(vk, proof, CHANGED, TestRng(SEED + 2))


def test_jax_verifier_accepts_port_bytes(proved):
    proof = jdeserialize_proof(JVesta, proved["raw"])
    assert jverifier.verify(proved["jindex"].verifier_index(), proof, PUBLIC, JTestRng(SEED + 1))


@pytest.mark.parametrize("public", [PUBLIC, CHANGED], ids=["true", "changed"])
def test_public_comm_and_evals_match_jax(proved, public):
    """to_batch's first evaluation is the public one (no prev challenges):
    the masked -sum p_i L_i and oracles' barycentric evaluations."""
    vk, jvk = proved["index"].verifier_index(), proved["jindex"].verifier_index()
    got = verifier.to_batch(vk, proved["proof"], public).evaluations[0]
    want = jverifier.to_batch(jvk, proved["jproof"], public).evaluations[0]
    assert got.commitment.chunks == want.commitment.chunks
    assert got.evaluations == want.evaluations

    o = verifier.oracles(vk, proved["proof"], got.commitment, public)
    jo = jverifier.oracles(jvk, proved["jproof"], want.commitment, public)
    assert o.public_evals == jo.public_evals
    assert (o.zeta, o.v, o.u, o.ft_eval0) == (jo.zeta, jo.v, jo.u, jo.ft_eval0)
