"""Runtime lookup tables end to end on the CPU, where the plain versions of
the kernels run. The circuit of tests/test_lookup.py
(test_runtime_table_prove_verify): a runtime table of id 0 whose first
column is 0..15 and whose second column (seeded by random.Random(13)) comes
at prove time, 8 Lookup rows of three lookups into it, the derived SRS of
its 32-point domain, TestRng(14). The port and the JAX package each prove
it once for the module, and
  - the runtime layout (offset, spec, selector) equals the JAX package's;
  - the port's proof bytes equal the JAX package's, with a runtime
    commitment and its evaluations;
  - each package's verifier accepts the other's bytes;
  - a changed runtime value and a wrong runtime-table layout raise
    ValueError in both.
Every comparison is exact."""

import random

import pytest
import torch

from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.circuits.gate import CircuitGate as JCircuitGate
from proof_systems_tpu.circuits.gate import GateType as JGateType
from proof_systems_tpu.circuits.gate import new_wires as jnew_wires
from proof_systems_tpu.circuits.lookup import RuntimeTableCfg as JRuntimeTableCfg
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
from proof_systems_tpu_torch.circuits.gate import CircuitGate, GateType, new_wires
from proof_systems_tpu_torch.circuits.lookup import RuntimeTableCfg
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.prover import create_proof
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_proof
from proof_systems_tpu_torch.utils.rng import TestRng

# the curve arithmetic of the plain versions dominates; two threads halve it
torch.set_num_threads(2)

RT_LEN, ROWS, SEED = 16, 8, 14


def runtime_circuit(cfg_cls, gate_cls, gate_type, wires):
    """The runtime-table circuit of tests/test_lookup.py over either
    package's types: (config, runtime data, gates, witness)."""
    rng = random.Random(13)
    cfg = cfg_cls(id=0, first_column=list(range(RT_LEN)))
    data = [rng.randrange(Fp.p) for _ in range(RT_LEN)]
    gates = [gate_cls(gate_type.Lookup, wires(r), []) for r in range(ROWS)]
    witness = [[0] * ROWS for _ in range(15)]
    for r in range(ROWS):
        witness[0][r] = 0  # runtime table id
        for slot in range(3):
            idx = rng.randrange(RT_LEN)
            witness[1 + 2 * slot][r] = idx
            witness[2 + 2 * slot][r] = data[idx]
    return cfg, data, gates, witness


@pytest.fixture(scope="module")
def proved():
    cfg, data, gates, witness = runtime_circuit(RuntimeTableCfg, CircuitGate, GateType,
                                                new_wires)
    cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=64, runtime_tables=[cfg],
                                 device="cpu")
    g = [derive_g(Vesta, i) for i in range(cs.domain.d1.n)]
    h = derive_h(Vesta)
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    proof = create_proof(index, witness, TestRng(SEED), runtime_tables=[(0, data)])

    jcfg, jdata, jgates, jwitness = runtime_circuit(JRuntimeTableCfg, JCircuitGate, JGateType,
                                                    jnew_wires)
    jcs = JConstraintSystem.create(JFp, jgates, public=0, max_poly_size=64,
                                   runtime_tables=[jcfg])
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    jproof = jcreate_proof(jindex, jwitness, JTestRng(SEED), runtime_tables=[(0, jdata)])
    return dict(index=index, jindex=jindex, data=data, witness=witness, proof=proof,
                raw=serialize_proof(Vesta, proof), jraw=jserialize_proof(JVesta, jproof))


def test_runtime_layout_matches_jax(proved):
    lcs, jlcs = proved["index"].cs.lookup_cs, proved["jindex"].cs.lookup_cs
    assert lcs.runtime_table_offset == jlcs.runtime_table_offset == 0
    assert lcs.runtime_tables_spec == jlcs.runtime_tables_spec == [(0, RT_LEN)]
    assert lcs.runtime_selector_d1 == jlcs.runtime_selector_d1
    assert lcs.lookup_table == jlcs.lookup_table


def test_proof_bytes_equal_jax(proved):
    assert proved["raw"] == proved["jraw"]
    assert proved["proof"].commitments.lookup.runtime is not None
    assert proved["proof"].evals.runtime_lookup_table is not None


def test_verifiers_accept_each_others_bytes(proved):
    vk = proved["index"].verifier_index()
    assert verifier.verify(vk, deserialize_proof(Vesta, proved["jraw"]), [], TestRng(SEED + 1))
    proof = jdeserialize_proof(JVesta, proved["raw"])
    assert jverifier.verify(proved["jindex"].verifier_index(), proof, [], JTestRng(SEED + 1))


@pytest.mark.parametrize("case", ["changed_value", "wrong_layout"])
def test_bad_runtime_tables_raise_as_jax(proved, case):
    """tests/test_lookup.py:104-114: a changed runtime value (a looked-up
    entry is then missing from the table) and a runtime table under another
    id than the configuration's."""
    data = list(proved["data"])
    if case == "changed_value":
        data[3] = (data[3] + 1) % Fp.p
        tables, match = [(0, data)], None
    else:
        tables, match = [(1, data)], "inconsistent"
    witness = proved["witness"]
    with pytest.raises(ValueError, match=match):
        create_proof(proved["index"], [list(c) for c in witness], TestRng(16),
                     runtime_tables=tables)
    with pytest.raises(ValueError, match=match):
        jcreate_proof(proved["jindex"], [list(c) for c in witness], JTestRng(16),
                      runtime_tables=tables)
