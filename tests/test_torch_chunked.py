"""Chunked proofs end to end on the CPU, where the plain versions of the
kernels run. The inputs of tests/test_prove_verify.py
(test_chunked_proving): bench_circuit(40) over a 32-point derived SRS, so a
64-point domain in 2 chunks with zk_rows 5, bench_witness(40), TestRng(70).
The port and the JAX package each prove it once for the module, and
  - the constraint systems agree (domain, zk_rows, 2 chunks);
  - the port's proof bytes equal the JAX package's, with 2 chunks a
    witness commitment and 14 t chunks;
  - each package's verifier accepts the other's bytes, and the port's
    rejects ft_eval1 + 1.
Every comparison is exact. The same domain with public inputs is
tests/test_torch_chunked_public.py."""

import copy

import pytest
import torch

from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits.builders import bench_circuit as jbench_circuit
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
from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
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

SRS_SIZE, GATES, SEED = 32, 40, 70


def prove_both(public: int = 0) -> dict:
    g, h = [derive_g(Vesta, i) for i in range(SRS_SIZE)], derive_h(Vesta)
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, GATES), public=public,
                                 max_poly_size=SRS_SIZE, device="cpu")
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    proof = create_proof(index, bench_witness(GATES), TestRng(SEED + public))
    jcs = JConstraintSystem.create(JFp, jbench_circuit(JFp, GATES), public=public,
                                   max_poly_size=SRS_SIZE)
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    jproof = jcreate_proof(jindex, bench_witness(GATES), JTestRng(SEED + public))
    return dict(index=index, jindex=jindex, proof=proof,
                raw=serialize_proof(Vesta, proof), jraw=jserialize_proof(JVesta, jproof))


@pytest.fixture(scope="module")
def proved():
    return prove_both()


def test_constraint_system_matches_jax(proved):
    cs, jcs = proved["index"].cs, proved["jindex"].cs
    assert (cs.domain.d1.n, cs.zk_rows) == (jcs.domain.d1.n, jcs.zk_rows) == (64, 5)
    assert proved["index"].num_chunks == proved["jindex"].num_chunks == 2
    assert cs.shift == jcs.shift and cs.sigma_d1 == jcs.sigma_d1


def test_proof_bytes_equal_jax(proved):
    assert proved["raw"] == proved["jraw"]
    commitments = proved["proof"].commitments
    assert [len(c.chunks) for c in commitments.w_comm] == [2] * 15
    assert len(commitments.t_comm.chunks) == 14


def test_verifiers_accept_each_others_bytes(proved):
    vk = proved["index"].verifier_index()
    assert verifier.verify(vk, deserialize_proof(Vesta, proved["jraw"]), [], TestRng(SEED + 1))
    proof = jdeserialize_proof(JVesta, proved["raw"])
    assert jverifier.verify(proved["jindex"].verifier_index(), proof, [], JTestRng(SEED + 1))


def test_port_verifier_rejects_changed_ft_eval1(proved):
    bad = copy.deepcopy(proved["proof"])
    bad.ft_eval1 = (bad.ft_eval1 + 1) % Fp.p
    assert not verifier.verify(proved["index"].verifier_index(), bad, [], TestRng(SEED + 2))
