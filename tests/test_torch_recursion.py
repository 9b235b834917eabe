"""Recursion challenges end to end on the CPU, where the plain versions of
the kernels run. The inputs of tests/test_prove_verify.py
(test_prove_and_verify_with_recursion_challenges): bench_circuit(22) over a
32-point derived SRS, one RecursionChallenge of 5 challenges drawn from
random.Random(60) with the commitment of its b_poly coefficients,
TestRng(61). The port and the JAX package each prove it once for the
module, and
  - the challenge's commitment equals the JAX package's;
  - the port's proof bytes equal the JAX package's;
  - the port's verifier accepts, and rejects a changed challenge;
  - the JAX package's verifier accepts the port's bytes, and the port's
    verifier the JAX package's.
Every comparison is exact."""

import copy
import random

import pytest
import torch

from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits.builders import bench_circuit as jbench_circuit
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.proof import RecursionChallenge as JRecursionChallenge
from proof_systems_tpu.prover import create_proof as jcreate_proof
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu.serialization import deserialize_proof as jdeserialize_proof
from proof_systems_tpu.serialization import serialize_proof as jserialize_proof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch import verifier
from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.commitment import b_poly_coefficients
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.proof import RecursionChallenge
from proof_systems_tpu_torch.prover import create_proof
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_proof
from proof_systems_tpu_torch.utils.rng import TestRng

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

N, GATES, SEED = 32, 22, 61


@pytest.fixture(scope="module")
def proved():
    rng = random.Random(60)
    chals = [rng.randrange(Fp.p) for _ in range(5)]  # log2(32) challenges
    g, h = [derive_g(Vesta, i) for i in range(N)], derive_h(Vesta)

    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, GATES), public=0, max_poly_size=N,
                                 device="cpu")
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    comm = index.srs.commit_coeffs_host([b_poly_coefficients(Fp, chals)])[0]
    proof = create_proof(index, bench_witness(GATES), TestRng(SEED),
                         prev_challenges=[RecursionChallenge(chals=list(chals), comm=comm)])

    jcs = JConstraintSystem.create(JFp, jbench_circuit(JFp, GATES), public=0, max_poly_size=N)
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    jcomm = jindex.srs.commit_coeffs_host([b_poly_coefficients(Fp, chals)])[0]
    jproof = jcreate_proof(jindex, bench_witness(GATES), JTestRng(SEED),
                           prev_challenges=[JRecursionChallenge(chals=list(chals), comm=jcomm)])
    return dict(index=index, jindex=jindex, comm=comm, jcomm=jcomm,
                raw=serialize_proof(Vesta, proof), jraw=jserialize_proof(JVesta, jproof))


def test_challenge_commitment_equals_jax(proved):
    assert proved["comm"].chunks == proved["jcomm"].chunks


def test_proof_bytes_equal_jax(proved):
    assert proved["raw"] == proved["jraw"]


def test_port_verifier_accepts_and_rejects_changed_challenge(proved):
    vk = proved["index"].verifier_index()
    proof = deserialize_proof(Vesta, proved["raw"])
    assert len(proof.prev_challenges) == 1
    assert verifier.verify(vk, proof, [], TestRng(SEED + 1))
    bad = copy.deepcopy(proof)
    bad.prev_challenges[0].chals[0] = (bad.prev_challenges[0].chals[0] + 1) % Fp.p
    assert not verifier.verify(vk, bad, [], TestRng(SEED + 2))


def test_verifiers_accept_each_others_bytes(proved):
    proof = jdeserialize_proof(JVesta, proved["raw"])
    assert jverifier.verify(proved["jindex"].verifier_index(), proof, [], JTestRng(SEED + 1))
    proof = deserialize_proof(Vesta, proved["jraw"])
    assert verifier.verify(proved["index"].verifier_index(), proof, [], TestRng(SEED + 3))
