"""The committed optional-gate vectors at n = 8,192, on the CPU: the JAX
package proves gate_mix.optional_circuit (one multi-range-check, a 64-bit
Xor, a Rot64, a ForeignFieldAdd chain and a ForeignFieldMul over
secp256k1's p, an And and a Not; both fixed lookup tables, so a domain of
8,192) over the derived 8,192-point SRS with TestRng(OPTIONAL_SEED), and
writes its verifier index to a file. Both byte strings must equal
tests/vectors/proof_optional_2^13.bin and vk_optional_2^13.bin (written when
absent); chip_smoke.py holds the port's proof and file on the card against
them. On the CPU, the port's VerifierIndex.from_file reads the vector file
back to the same bytes and its verify accepts the vector proof and rejects
it with a changed optional-selector evaluation; deserialize_proof then
serialize_proof returns the vector's bytes. (A port proof at this size
through the plain versions would take far too long here.)"""

import copy
import pathlib

import pytest
import torch

from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.circuits.polynomials import optional_witness as jow
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.prover import create_proof as jcreate_proof
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu.serialization import serialize_proof as jserialize_proof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch import verifier
from proof_systems_tpu_torch.circuits import gate_mix
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.serialization import (
    deserialize_proof,
    serialize_proof,
    serialize_verifier_index,
)
from proof_systems_tpu_torch.utils.rng import TestRng
from proof_systems_tpu_torch.verifier_index import VerifierIndex

torch.set_num_threads(2)

VECTORS = pathlib.Path(__file__).parent / "vectors"
PROOF, VK = VECTORS / "proof_optional_2^13.bin", VECTORS / "vk_optional_2^13.bin"
SEED, N = gate_mix.OPTIONAL_SEED, 1 << 13


@pytest.fixture(scope="module")
def vectors(tmp_path_factory):
    """The JAX package's proof bytes and verifier-index file, and the SRS
    points of both packages."""
    g, h = [derive_g(Vesta, i) for i in range(N)], derive_h(Vesta)
    gates, witness = gate_mix.optional_circuit(SEED, ow=jow, f=JFp)
    jcs = JConstraintSystem.create(JFp, gates, public=0, max_poly_size=N)
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    raw = jserialize_proof(JVesta, jcreate_proof(jindex, witness, JTestRng(SEED)))
    path = tmp_path_factory.mktemp("vk") / "vk_optional.bin"
    jindex.verifier_index().to_file(path)
    for vector, data in ((PROOF, raw), (VK, path.read_bytes())):
        if not vector.exists():
            vector.write_bytes(data)
    return dict(raw=raw, vk=path.read_bytes(), srs=SRS(Vesta, g, h, torch.device("cpu")),
                n=jcs.domain.d1.n)


def test_jax_package_reproduces_the_vectors(vectors):
    assert vectors["n"] == N
    assert vectors["raw"] == PROOF.read_bytes()
    assert vectors["vk"] == VK.read_bytes()


def test_port_reads_the_vector_files(vectors):
    vk = VerifierIndex.from_file(VK, vectors["srs"])
    assert serialize_verifier_index(vk) == VK.read_bytes()
    assert vk.domain.n == N and vk.lookup_index is not None
    assert all(getattr(vk, c) is not None for c in (
        "range_check0_comm", "range_check1_comm", "foreign_field_add_comm",
        "foreign_field_mul_comm", "xor_comm", "rot_comm"))
    raw = PROOF.read_bytes()
    assert serialize_proof(Vesta, deserialize_proof(Vesta, raw)) == raw


@pytest.mark.parametrize("changed", [None, "rot_selector", "range_check1_selector"])
def test_port_verifier_on_the_vector_proof(vectors, changed):
    vk = VerifierIndex.from_file(VK, vectors["srs"])
    proof = deserialize_proof(Vesta, PROOF.read_bytes())
    if changed is not None:
        proof = copy.deepcopy(proof)
        pt = getattr(proof.evals, changed)
        pt.zeta[0] = (pt.zeta[0] + 1) % Fp.p
    assert verifier.verify(vk, proof, [], TestRng(SEED + 1)) == (changed is None)
