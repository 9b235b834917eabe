"""A proof of the Keccak gadgets' bitwise rows on the CPU, where the plain
versions of the kernels run: a 64-bit Xor, an And and a Not of three words
(tests/test_gates.py's And/Not circuit with a Xor before it; 17 rows), the
XOR table (id 0, 256 rows) bounding the domain at 512, over the derived
512-point SRS, TestRng(SEED). Both packages build it with their own gadgets
from the same seed and prove it once for the module, and
  - the lookup constraint system (the XOR table, the Xor pattern) and the
    selectors agree;
  - the port's proof bytes equal the JAX package's;
  - each package's verifier accepts the other's bytes, and the port's
    rejects a changed xor_selector evaluation and a changed Xor lookup
    selector evaluation.
Every comparison is exact."""

import copy
import random

import pytest
import torch

from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.circuits.polynomials import optional_witness as jow
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.prover import create_proof as jcreate_proof
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu.serialization import deserialize_proof as jdeserialize_proof
from proof_systems_tpu.serialization import serialize_proof as jserialize_proof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch import verifier
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.circuits.gate import GateType
from proof_systems_tpu_torch.circuits.polynomials import optional_witness
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.prover import create_proof
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_proof
from proof_systems_tpu_torch.utils.rng import TestRng

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

SEED, N = 114, 512


def bitwise_circuit(ow, f):
    """Xor (5 rows), And (6) and Not of three words (2) of seeded 64-bit
    words: (gates, witness)."""
    rng = random.Random(SEED)
    witness = [[0] * 13 for _ in range(15)]
    gates = ow.create_xor_gadget(0, 64)
    ow.xor_witness(witness, 0, rng.getrandbits(64), rng.getrandbits(64), 64)
    gates += ow.create_and_gadget(5, f, 64)
    ow.and_witness(witness, 5, rng.getrandbits(64), rng.getrandbits(64), 64)
    gates += ow.create_not_gadget(11, f, 3, 64)
    ow.not_witness(witness, 11, [rng.getrandbits(64) for _ in range(3)], 64)
    assert len(gates) == 13
    return gates, witness


@pytest.fixture(scope="module")
def proved():
    g, h = [derive_g(Vesta, i) for i in range(N)], derive_h(Vesta)
    gates, witness = bitwise_circuit(optional_witness, Fp)
    cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=N, device="cpu")
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    proof = create_proof(index, witness, TestRng(SEED))
    jgates, jwitness = bitwise_circuit(jow, JFp)
    jcs = JConstraintSystem.create(JFp, jgates, public=0, max_poly_size=N)
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    jproof = jcreate_proof(jindex, jwitness, JTestRng(SEED))
    return dict(index=index, jindex=jindex, proof=proof, raw=serialize_proof(Vesta, proof),
                jraw=jserialize_proof(JVesta, jproof))


def test_constraint_system_matches_jax(proved):
    cs, jcs = proved["index"].cs, proved["jindex"].cs
    assert cs.domain.d1.n == jcs.domain.d1.n == N
    assert cs.feature_flags == {GateType.Xor16}
    assert {int(g): s for g, s in cs.selectors_d1.items()} == {
        int(g): s for g, s in jcs.selectors_d1.items()}
    lcs, jlcs = cs.lookup_cs, jcs.lookup_cs
    assert [p.value for p in lcs.info.patterns] == [p.value for p in jlcs.info.patterns] == ["xor"]
    assert lcs.lookup_table == jlcs.lookup_table and len(lcs.lookup_table[0]) == N
    assert {p.value: s for p, s in lcs.selectors_d1.items()} == {
        p.value: s for p, s in jlcs.selectors_d1.items()}


def test_proof_bytes_equal_jax(proved):
    assert proved["raw"] == proved["jraw"]
    assert proved["index"].verifier_index().digest() == proved["jindex"].verifier_index().digest()


def test_verifiers_accept_each_others_bytes(proved):
    vk = proved["index"].verifier_index()
    assert verifier.verify(vk, deserialize_proof(Vesta, proved["jraw"]), [], TestRng(SEED + 1))
    proof = jdeserialize_proof(JVesta, proved["raw"])
    assert jverifier.verify(proved["jindex"].verifier_index(), proof, [], JTestRng(SEED + 1))


@pytest.mark.parametrize("field", ["xor_selector", "xor_lookup_selector"])
def test_port_verifier_rejects_changed_selector_evaluation(proved, field):
    bad = copy.deepcopy(proved["proof"])
    pt = getattr(bad.evals, field)
    pt.zeta[0] = (pt.zeta[0] + 1) % Fp.p
    assert not verifier.verify(proved["index"].verifier_index(), bad, [], TestRng(SEED + 2))
