"""The committed o1vm column-proof vectors, written by the JAX package on the
CPU from the inputs of its heavy end-to-end tests:
  - column_keccak_2^5: tests/test_keccak.py's keccak-f proof (state0 from
    random.Random(93), n = 32, the derived 32-point SRS, TestRng(61));
  - column_riscv_2^8: tests/test_riscv.py's RV32IM proof (its seven
    instructions, Layout(2), n = 256, TestRng(81)).
Each is a .bin (serialization.serialize_column_proof of the ColumnProof's
fields: compressed 33-byte points, 32-byte elements) and a .json (the
statement). chip_smoke.py and tests/test_torch_cuda.py hold the port's
proofs on the card against them field by field; a port proof of 4,225
columns through the plain versions would take far too long here.

The heavy test has the JAX package prove both again, compares them with the
files (writing a file that is absent) and verifies the proofs read back
from them; like the JAX package's own proofs it is skipped unless
PST_HEAVY=1. The others load each file into the port's ColumnProof, write it
back to the same bytes, and check the statement with the port's host code."""

import json
import pathlib
import random

import pytest

from proof_systems_tpu.circuits.domains import EvaluationDomains as JEvaluationDomains
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.o1vm import keccak as jkeccak
from proof_systems_tpu.o1vm import pickles as jpickles
from proof_systems_tpu.o1vm import riscv as jriscv
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poly_commitment.commitment import PolyComm as JPolyComm
from proof_systems_tpu.poly_commitment.ipa import OpeningProof as JOpeningProof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch.convert import column_proof_fields, column_proof_from_fields
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.o1vm import keccak, pickles, riscv
from proof_systems_tpu_torch.serialization import (
    deserialize_column_proof,
    serialize_column_proof,
)

VECTORS = pathlib.Path(__file__).parent / "vectors"
JCLASSES = (jpickles.ColumnProof, JPolyComm, JOpeningProof)
CASES = {"keccak": ("column_keccak_2^5", 32), "riscv": ("column_riscv_2^8", 256)}


def keccak_state0():
    """tests/test_keccak.py's statement."""
    rng = random.Random(93)
    return [[rng.getrandbits(64) for _ in range(5)] for _ in range(5)]


def riscv_program(mod):
    """tests/test_riscv.py's end-to-end program, in either package's Instr."""
    return [
        mod.Instr("ADDI", rd=1, rs1=0, imm=96),
        mod.Instr("ADDI", rd=2, rs1=0, imm=7),
        mod.Instr("DIVU", rd=3, rs1=1, rs2=2),
        mod.Instr("AND", rd=4, rs1=1, rs2=2),
        mod.Instr("SW", rs1=0, rs2=3, imm=16),
        mod.Instr("LB", rd=5, rs1=0, imm=16),
        mod.Instr("MULH", rd=6, rs1=1, rs2=2),
    ]


def paths(case: str):
    stem = CASES[case][0]
    return VECTORS / f"{stem}.bin", VECTORS / f"{stem}.json"


def jax_prove(case: str):
    """The JAX package's proof, the statement as the .json holds it, and a
    function that verifies a ColumnProof of the JAX package against it."""
    n = CASES[case][1]
    domain = JEvaluationDomains.create(JFp, n)
    srs = jsrs.SRS(JVesta, [jsrs.derive_g(JVesta, i) for i in range(n)], jsrs.derive_h(JVesta))
    if case == "keccak":
        state0 = keccak_state0()
        proof, final = jkeccak.prove_keccak(domain, srs, JVesta, state0, JTestRng(61))
        return proof, {"n": n, "state0": state0, "final": final}, (
            lambda p: jkeccak.verify_keccak(domain, srs, JVesta, p, state0, final, JTestRng(62)))
    layout = jriscv.Layout(bitwise_bits=2)
    proof, statement = jriscv.prove_execution(domain, srs, JVesta, riscv_program(jriscv), n,
                                              JTestRng(81), L=layout)
    return proof, {"n": n, "statement": riscv.statement_to_json(statement)}, (
        lambda p: jriscv.verify_execution(domain, srs, JVesta, p, statement, JTestRng(82)))


@pytest.mark.heavy
@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_package_reproduces_and_accepts_the_vector(case):
    proof, statement, verify = jax_prove(case)
    raw = serialize_column_proof(Vesta, column_proof_fields(proof))
    text = json.dumps(statement, sort_keys=True) + "\n"
    bin_path, json_path = paths(case)
    for path, data in ((bin_path, raw), (json_path, text.encode())):
        if not path.exists():
            path.write_bytes(data)
    assert raw == bin_path.read_bytes()
    assert json.loads(json_path.read_text()) == json.loads(text)
    fields = deserialize_column_proof(Vesta, bin_path.read_bytes())
    assert verify(column_proof_from_fields(fields, JCLASSES))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vector_loads_into_the_port_and_round_trips(case):
    bin_path, json_path = paths(case)
    raw = bin_path.read_bytes()
    proof = column_proof_from_fields(deserialize_column_proof(Vesta, raw))
    assert isinstance(proof, pickles.ColumnProof)
    assert serialize_column_proof(Vesta, column_proof_fields(proof)) == raw
    statement = json.loads(json_path.read_text())
    n = statement["n"]
    assert n == CASES[case][1]
    if case == "keccak":
        ncols = keccak.LAYOUT.ncols + 65  # the bit columns, selector, round constants
        assert statement["state0"] == keccak_state0()
        assert statement["final"] == keccak.keccak_f(statement["state0"])
    else:
        st = riscv.statement_from_json(statement["statement"])
        assert riscv.statement_to_json(st) == statement["statement"]
        assert [(i.op, i.rd, i.rs1, i.rs2, i.imm) for i in st["program"]] == [
            (i.op, i.rd, i.rs1, i.rs2, i.imm) for i in riscv_program(riscv)]
        rows, state = riscv.execute(st["program"], n // 2)
        assert st["k_steps"] == len(rows)
        assert st["final"]["regs"] == state["regs"] and st["final"]["pc"] == state["pc"]
        assert st["final"]["memory"] == state["memory"]
        assert st["final"]["regs"][5] == 13  # tests/test_riscv.py's check
        logup = riscv.make_logup(Vesta.scalar, st["program"], n, riscv.Layout(2))
        ncols = logup.phase1_end + logup.num_phase2
    assert len(proof.commitments) == len(proof.zeta_evaluations) == ncols
    assert len(proof.quotient_commitment.chunks) == pickles.DEGREE_QUOTIENT_POLYNOMIAL
    assert len(proof.opening.lr) == n.bit_length() - 1
