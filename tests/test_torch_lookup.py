"""Lookups with a fixed table, end to end on the CPU, where the plain
versions of the kernels run. The circuit of tests/test_lookup.py
(lookup_circuit(8, 16): 8 Lookup rows of three lookups into the table
(x, x^2) of 16 entries, id 0) over the derived SRS of its 32-point domain,
TestRng(11). The port and the JAX package each prove it once for the
module, and
  - the lookup constraint systems agree (table, ids, selectors);
  - the port's proof bytes equal the JAX package's;
  - each package's verifier accepts the other's bytes, and the port's
    rejects a changed sorted evaluation;
  - a witness value that is not in the table raises ValueError in both;
  - batch_verify over this proof and the bench proof of a 32-point domain
    on the same SRS accepts, rejects when one has ft_eval1 + 1, and agrees
    with the JAX package's batch_verify on the same bytes.
Every comparison is exact. Runtime tables: tests/test_torch_lookup_runtime.py."""

import copy
import random

import pytest
import torch

from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits.builders import bench_circuit as jbench_circuit
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.circuits.gate import CircuitGate as JCircuitGate
from proof_systems_tpu.circuits.gate import GateType as JGateType
from proof_systems_tpu.circuits.gate import new_wires as jnew_wires
from proof_systems_tpu.circuits.lookup import LookupTable as JLookupTable
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
from proof_systems_tpu_torch.circuits.gate import CircuitGate, GateType, new_wires
from proof_systems_tpu_torch.circuits.lookup import LookupTable
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.prover import create_proof
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_proof
from proof_systems_tpu_torch.utils.rng import TestRng

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

ROWS, TABLE_LEN, SEED = 8, 16, 11


def lookup_circuit(table_cls, gate_cls, gate_type, wires, num_lookup_rows: int, table_len: int):
    """tests/test_lookup.py's lookup_circuit over either package's types."""
    rng = random.Random(9)
    table = table_cls(0, [list(range(table_len)), [i * i for i in range(table_len)]])
    gates = [gate_cls(gate_type.Lookup, wires(r), []) for r in range(num_lookup_rows)]
    witness = [[0] * num_lookup_rows for _ in range(15)]
    for r in range(num_lookup_rows):
        witness[0][r] = 0  # table id
        for slot in range(3):
            idx = rng.randrange(table_len)
            witness[1 + 2 * slot][r] = idx
            witness[2 + 2 * slot][r] = table.data[1][idx]
    return gates, witness, table


def port_index(gates, table, srs=None, **kw):
    cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=64,
                                 fixed_lookup_tables=[table] if table else None,
                                 device="cpu", **kw)
    n = cs.domain.d1.n
    if srs is None:
        srs = SRS(Vesta, [derive_g(Vesta, i) for i in range(n)], derive_h(Vesta),
                  torch.device("cpu"))
    return ProverIndex(cs, Vesta, srs)


def jax_index(gates, table, srs=None, **kw):
    jcs = JConstraintSystem.create(JFp, gates, public=0, max_poly_size=64,
                                   fixed_lookup_tables=[table] if table else None, **kw)
    n = jcs.domain.d1.n
    if srs is None:
        srs = jsrs.SRS(JVesta, [derive_g(Vesta, i) for i in range(n)], derive_h(Vesta))
    return JProverIndex(jcs, JVesta, srs)


@pytest.fixture(scope="module")
def proved():
    gates, witness, table = lookup_circuit(LookupTable, CircuitGate, GateType, new_wires,
                                           ROWS, TABLE_LEN)
    index = port_index(gates, table)
    proof = create_proof(index, witness, TestRng(SEED))
    jgates, jwitness, jtable = lookup_circuit(JLookupTable, JCircuitGate, JGateType,
                                              jnew_wires, ROWS, TABLE_LEN)
    jindex = jax_index(jgates, jtable)
    jproof = jcreate_proof(jindex, jwitness, JTestRng(SEED))
    return dict(index=index, jindex=jindex, witness=witness, proof=proof,
                raw=serialize_proof(Vesta, proof), jraw=jserialize_proof(JVesta, jproof))


def test_lookup_constraint_system_matches_jax(proved):
    lcs, jlcs = proved["index"].cs.lookup_cs, proved["jindex"].cs.lookup_cs
    assert proved["index"].cs.domain.d1.n == proved["jindex"].cs.domain.d1.n == 32
    assert lcs.lookup_table == jlcs.lookup_table and lcs.table_ids == jlcs.table_ids
    assert [p.value for p in lcs.info.patterns] == [p.value for p in jlcs.info.patterns]
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


def test_port_verifier_rejects_changed_sorted_evaluation(proved):
    bad = copy.deepcopy(proved["proof"])
    bad.evals.lookup_sorted[0].zeta[0] = (bad.evals.lookup_sorted[0].zeta[0] + 1) % Fp.p
    assert not verifier.verify(proved["index"].verifier_index(), bad, [], TestRng(SEED + 2))


def test_value_not_in_table_raises_as_jax(proved):
    """tests/test_lookup.py:51-66 on this file's index: a looked-up value
    that is not in the table."""
    witness = [list(c) for c in proved["witness"]]
    witness[2][1] = 9999
    with pytest.raises(ValueError, match="not in table"):
        create_proof(proved["index"], witness, TestRng(13))
    with pytest.raises(ValueError, match="not in table"):
        jcreate_proof(proved["jindex"], [list(c) for c in witness], JTestRng(13))


@pytest.fixture(scope="module")
def batch(proved):
    """This file's lookup proof and a bench proof of a 32-point domain,
    both over the lookup index's SRS, in either package."""
    bench = ProverIndex(ConstraintSystem.create(Fp, bench_circuit(Fp, 22), public=0,
                                                max_poly_size=32, device="cpu"),
                        Vesta, proved["index"].srs)
    braw = serialize_proof(Vesta, create_proof(bench, bench_witness(22), TestRng(5)))
    jbench = JProverIndex(JConstraintSystem.create(JFp, jbench_circuit(JFp, 22), public=0,
                                                   max_poly_size=32),
                          JVesta, proved["jindex"].srs)
    return dict(vks=[proved["index"].verifier_index(), bench.verifier_index()],
                jvks=[proved["jindex"].verifier_index(), jbench.verifier_index()],
                raws=[proved["raw"], braw])


@pytest.mark.parametrize("changed", [None, 0, 1], ids=["honest", "lookup_bad", "bench_bad"])
def test_batch_verify_agrees_with_jax(batch, changed):
    proofs = [deserialize_proof(Vesta, r) for r in batch["raws"]]
    jproofs = [jdeserialize_proof(JVesta, r) for r in batch["raws"]]
    if changed is not None:
        proofs[changed].ft_eval1 = (proofs[changed].ft_eval1 + 1) % Fp.p
        jproofs[changed].ft_eval1 = (jproofs[changed].ft_eval1 + 1) % Fp.p
    got = verifier.batch_verify([(vk, pr, []) for vk, pr in zip(batch["vks"], proofs)],
                                TestRng(SEED + 4))
    want = jverifier.batch_verify([(vk, pr, []) for vk, pr in zip(batch["jvks"], jproofs)],
                                  JTestRng(SEED + 4))
    assert got == want == (changed is None)
