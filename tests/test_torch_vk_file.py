"""The verifier index on disk, on the CPU: serialize_verifier_index,
VerifierIndex.to_file and from_file, against the JAX package's. For the
bench index of tests/test_prove_verify.py (make_index(22, 32)) and the
lookup index of tests/test_lookup.py (lookup_circuit(8, 16)):
  - the port's file bytes equal the JAX package's;
  - from_file of the port's file keeps the digest, shift, endo, zk_w and
    the lookup index;
  - the JAX package's from_file reads the port's file, and the port's reads
    the JAX package's, each with the other's digest;
  - the bench index reloaded by the port verifies the fixed 2^5 proof of
    tests/vectors/proof_2^5.bin.
Every comparison is exact."""

import functools
import pathlib

import pytest
import torch

from proof_systems_tpu.circuits.builders import bench_circuit as jbench_circuit
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.circuits.gate import CircuitGate as JCircuitGate
from proof_systems_tpu.circuits.gate import GateType as JGateType
from proof_systems_tpu.circuits.gate import new_wires as jnew_wires
from proof_systems_tpu.circuits.lookup import LookupTable as JLookupTable
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu.serialization import serialize_verifier_index as jserialize_vk
from proof_systems_tpu.verifier_index import VerifierIndex as JVerifierIndex
from proof_systems_tpu_torch import verifier
from proof_systems_tpu_torch.circuits.builders import bench_circuit
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.circuits.gate import CircuitGate, GateType, new_wires
from proof_systems_tpu_torch.circuits.lookup import LookupTable
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_verifier_index
from proof_systems_tpu_torch.utils.rng import TestRng
from proof_systems_tpu_torch.verifier_index import VerifierIndex

from test_torch_lookup import TABLE_LEN, lookup_circuit

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

FIXTURE = pathlib.Path(__file__).parent / "vectors" / "proof_2^5.bin"
N = 32


@functools.cache
def built(kind: str):
    """The port's and the JAX package's index of one kind, over the derived
    32-point SRS (built once for the module)."""
    g, h = [derive_g(Vesta, i) for i in range(N)], derive_h(Vesta)
    if kind == "bench":
        cs = ConstraintSystem.create(Fp, bench_circuit(Fp, 22), public=0, max_poly_size=N,
                                     device="cpu")
        jcs = JConstraintSystem.create(JFp, jbench_circuit(JFp, 22), public=0, max_poly_size=N)
    else:
        gates, _, table = lookup_circuit(LookupTable, CircuitGate, GateType, new_wires, 8,
                                         TABLE_LEN)
        cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=64,
                                     fixed_lookup_tables=[table], device="cpu")
        jgates, _, jtable = lookup_circuit(JLookupTable, JCircuitGate, JGateType, jnew_wires, 8,
                                           TABLE_LEN)
        jcs = JConstraintSystem.create(JFp, jgates, public=0, max_poly_size=64,
                                       fixed_lookup_tables=[jtable])
    assert cs.domain.d1.n == N
    return (ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu"))),
            JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h)))


@pytest.fixture(scope="module", params=["bench", "lookup"])
def pair(request, tmp_path_factory):
    index, jindex = built(request.param)
    vk, jvk = index.verifier_index(), jindex.verifier_index()
    tmp = tmp_path_factory.mktemp(f"vk_{request.param}")
    vk.to_file(tmp / "port.bin")
    jvk.to_file(tmp / "jax.bin")
    return dict(kind=request.param, index=index, jindex=jindex, vk=vk, jvk=jvk,
                path=tmp / "port.bin", jpath=tmp / "jax.bin")


def test_file_bytes_equal_jax(pair):
    raw = serialize_verifier_index(pair["vk"])
    assert raw == jserialize_vk(pair["jvk"])
    assert pair["path"].read_bytes() == pair["jpath"].read_bytes() == raw
    assert pair["vk"].digest() == pair["jvk"].digest()


def test_round_trip_keeps_the_index(pair):
    vk = pair["vk"]
    back = VerifierIndex.from_file(pair["path"], pair["index"].srs)
    assert back.digest() == vk.digest()
    assert (back.shift, back.endo, back.zk_w) == (vk.shift, vk.endo, vk.zk_w)
    assert (back.domain.n, back.max_poly_size, back.zk_rows) == (N, N, vk.zk_rows)
    if pair["kind"] == "lookup":
        li, li2 = vk.lookup_index, back.lookup_index
        assert li2.lookup_info.patterns == li.lookup_info.patterns
        assert li2.joint_lookup_used == li.joint_lookup_used
        assert li2.lookup_selectors == li.lookup_selectors
        assert li2.lookup_table == li.lookup_table and li2.table_ids == li.table_ids
    else:
        assert back.lookup_index is None


def test_each_package_reads_the_others_file(pair):
    jback = JVerifierIndex.from_file(pair["path"], pair["jindex"].srs)
    assert jback.digest() == pair["jvk"].digest()
    back = VerifierIndex.from_file(pair["jpath"], pair["index"].srs)
    assert back.digest() == pair["vk"].digest()


def test_reloaded_bench_index_verifies_the_fixed_proof(tmp_path):
    index, _ = built("bench")
    index.verifier_index().to_file(tmp_path / "vk.bin")
    back = VerifierIndex.from_file(tmp_path / "vk.bin", index.srs)
    proof = deserialize_proof(Vesta, FIXTURE.read_bytes())
    assert verifier.verify(back, proof, [], TestRng(6))
    proof.ft_eval1 = (proof.ft_eval1 + 1) % Fp.p
    assert not verifier.verify(back, proof, [], TestRng(7))
