"""A proof with real rows of every always-on gate, on the CPU, where the
plain versions of the kernels run: gate_mix.always_on_circuit (one each of
the Poseidon, CompleteAdd, VarBaseMul, EndoMul and EndoMulScalar gadgets and
a ForeignFieldAdd chain; 26 rows, a 32-point domain, no lookup table) over
the derived 32-point SRS, TestRng(SEED). The port builds it with its own
gadgets, the JAX package with its own, from the same seed; each proves it
once for the module, and
  - the constraint systems agree (selectors, feature flags, sigma);
  - the port's proof bytes equal the JAX package's and
    tests/vectors/proof_gates_2^5.bin (written when absent; the card's
    check in chip_smoke.py reads it);
  - each package's verifier accepts the other's bytes, and the port's
    rejects a changed foreign_field_add_selector evaluation and a changed
    Poseidon selector evaluation.
Every comparison is exact."""

import copy
import pathlib

import pytest
import torch

from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits import gate as jgate
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.circuits.polynomials import optional_witness as jow
from proof_systems_tpu.circuits.polynomials import witness_gen as jwg
from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poseidon import fp_kimchi as jfp_kimchi
from proof_systems_tpu.prover import create_proof as jcreate_proof
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu.serialization import deserialize_proof as jdeserialize_proof
from proof_systems_tpu.serialization import serialize_proof as jserialize_proof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch import verifier
from proof_systems_tpu_torch.circuits import gate_mix
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.circuits.gate import GateType
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.prover import create_proof
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_proof
from proof_systems_tpu_torch.utils.rng import TestRng

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

VECTOR = pathlib.Path(__file__).parent / "vectors" / "proof_gates_2^5.bin"
SEED, N = gate_mix.ALWAYS_ON_SEED, 32


@pytest.fixture(scope="module")
def proved():
    g, h = [derive_g(Vesta, i) for i in range(N)], derive_h(Vesta)
    gates, witness = gate_mix.always_on_circuit(SEED)
    cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=N, device="cpu")
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    proof = create_proof(index, witness, TestRng(SEED))
    jgates, jwitness = gate_mix.always_on_circuit(SEED, wg=jwg, ow=jow, gate=jgate,
                                                  curve=JPallas, f=JFp, params=jfp_kimchi)
    jcs = JConstraintSystem.create(JFp, jgates, public=0, max_poly_size=N)
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    jproof = jcreate_proof(jindex, jwitness, JTestRng(SEED))
    return dict(index=index, jindex=jindex, witness=witness, jwitness=jwitness, proof=proof,
                raw=serialize_proof(Vesta, proof), jraw=jserialize_proof(JVesta, jproof))


def test_constraint_system_matches_jax(proved):
    cs, jcs = proved["index"].cs, proved["jindex"].cs
    assert cs.domain.d1.n == jcs.domain.d1.n == N
    assert proved["witness"] == proved["jwitness"]
    assert {int(g): s for g, s in cs.selectors_d1.items()} == {
        int(g): s for g, s in jcs.selectors_d1.items()}
    assert {int(g) for g in cs.feature_flags} == {int(g) for g in jcs.feature_flags} == {
        int(jgate.GateType.ForeignFieldAdd)}
    assert cs.sigma_d1 == jcs.sigma_d1 and cs.lookup_cs is None is jcs.lookup_cs
    for g in (GateType.Poseidon, GateType.CompleteAdd, GateType.VarBaseMul, GateType.EndoMul,
              GateType.EndoMulScalar, GateType.ForeignFieldAdd):
        assert any(cs.selectors_d1[g])


def test_proof_bytes_equal_jax_and_vector(proved):
    assert proved["raw"] == proved["jraw"]
    assert proved["index"].verifier_index().digest() == proved["jindex"].verifier_index().digest()
    if not VECTOR.exists():
        VECTOR.write_bytes(proved["jraw"])
    assert proved["raw"] == VECTOR.read_bytes()


def test_verifiers_accept_each_others_bytes(proved):
    vk = proved["index"].verifier_index()
    assert verifier.verify(vk, deserialize_proof(Vesta, proved["jraw"]), [], TestRng(SEED + 1))
    proof = jdeserialize_proof(JVesta, proved["raw"])
    assert jverifier.verify(proved["jindex"].verifier_index(), proof, [], JTestRng(SEED + 1))


@pytest.mark.parametrize("field", ["foreign_field_add_selector", "poseidon_selector"])
def test_port_verifier_rejects_changed_selector_evaluation(proved, field):
    bad = copy.deepcopy(proved["proof"])
    pt = getattr(bad.evals, field)
    pt.zeta[0] = (pt.zeta[0] + 1) % Fp.p
    assert not verifier.verify(proved["index"].verifier_index(), bad, [], TestRng(SEED + 2))
