"""The committed o1vm column-proof vectors, written by the JAX package on the
CPU from the inputs of its heavy end-to-end tests:
  - column_keccak_2^5: tests/test_keccak.py's keccak-f proof (state0 from
    random.Random(93), n = 32, the derived 32-point SRS, TestRng(61));
  - column_riscv_2^8: tests/test_riscv.py's RV32IM proof (its seven
    instructions, Layout(2), n = 256, TestRng(81));
  - column_mips_2^8: tests/test_mips.py's MIPS proof (its nine
    instructions, Layout(2), n = 256, TestRng(71));
  - column_mips_cannon_2^9: tests/test_mips.py's Cannon snapshot segment
    (pc0 = 0x1000, a preimage key write, reads of its stream, exit_group(3);
    Layout(2), n = 512, TestRng(81)).
Each is a .bin (serialization.serialize_column_proof of the ColumnProof's
fields: compressed 33-byte points, 32-byte elements) and a .json (the
statement). chip_smoke.py and tests/test_torch_cuda.py hold the port's
proofs on the card against them field by field; a port proof of 4,225
columns (or of MIPS's 417) through the plain versions would take far too long
here.

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
from proof_systems_tpu.o1vm import mips as jmips
from proof_systems_tpu.o1vm import pickles as jpickles
from proof_systems_tpu.o1vm import riscv as jriscv
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poly_commitment.commitment import PolyComm as JPolyComm
from proof_systems_tpu.poly_commitment.ipa import OpeningProof as JOpeningProof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch.convert import column_proof_fields, column_proof_from_fields
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.o1vm import keccak, mips, pickles, riscv
from proof_systems_tpu_torch.serialization import (
    deserialize_column_proof,
    serialize_column_proof,
)

VECTORS = pathlib.Path(__file__).parent / "vectors"
JCLASSES = (jpickles.ColumnProof, JPolyComm, JOpeningProof)
CASES = {"keccak": ("column_keccak_2^5", 32), "riscv": ("column_riscv_2^8", 256),
         "mips": ("column_mips_2^8", 256), "mips_cannon": ("column_mips_cannon_2^9", 512)}


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


def mips_program(mod):
    """tests/test_mips.py's end-to-end program, in either package's Instr."""
    I = mod.Instr  # noqa: E741
    return [
        I("ADDIU", rt=1, rs=0, imm=6), I("ADDIU", rt=2, rs=0, imm=7),
        I("AND", rd=3, rs=1, rt=2), I("MULT", rs=1, rt=2), I("MFLO", rd=4),
        I("SW", rt=4, rs=0, imm=32), I("LW", rt=5, rs=0, imm=32),
        I("SRA", rd=6, rt=5, imm=1), I("SLT", rd=7, rs=1, rt=2),
    ]


SNAPSHOT_PC0 = 0x1000
SNAPSHOT_KEY = bytes(range(64, 96))
SNAPSHOT_PREIMAGES = {SNAPSHOT_KEY: b"\x11\x22\x33\x44"}


def snapshot_program(mod):
    """tests/test_mips.py's Cannon snapshot segment (at pc0 = 0x1000): the
    32-byte key at 0x100 written to the preimage fd 4 bytes at a time, the
    8-byte length prefix and 4 data bytes read back, a load of the data word,
    then exit_group(3)."""
    I = mod.Instr  # noqa: E741
    prog = [I("ADDIU", rt=4, rs=0, imm=6), I("ADDIU", rt=6, rs=0, imm=4)]
    for w in range(8):
        prog += [I("ADDIU", rt=2, rs=0, imm=4004), I("ADDIU", rt=5, rs=0, imm=0x100 + 4 * w),
                 I("SYSCALL")]
    prog += [I("ADDIU", rt=4, rs=0, imm=5)]
    for a in (0x200, 0x204, 0x208):
        prog += [I("ADDIU", rt=2, rs=0, imm=4003), I("ADDIU", rt=5, rs=0, imm=a), I("SYSCALL")]
    return prog + [I("LW", rt=9, rs=0, imm=0x208), I("ADDIU", rt=2, rs=0, imm=4246),
                   I("ADDIU", rt=4, rs=0, imm=3), I("SYSCALL")]


def snapshot_memory():
    """The snapshot's data: the key's eight big-endian words at 0x100."""
    return {0x100 + 4 * w: int.from_bytes(SNAPSHOT_KEY[4 * w:4 * w + 4], "big") for w in range(8)}


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
    if case in ("mips", "mips_cannon"):
        kw = dict(memory=snapshot_memory(), pc0=SNAPSHOT_PC0, preimages=SNAPSHOT_PREIMAGES) if (
            case == "mips_cannon") else {}
        program = snapshot_program(jmips) if kw else mips_program(jmips)
        seed = 81 if kw else 71
        proof, statement = jmips.prove_execution(domain, srs, JVesta, program, n, JTestRng(seed),
                                                 L=jmips.Layout(bitwise_bits=2), **kw)
        return proof, {"n": n, "statement": mips.statement_to_json(statement)}, (
            lambda p: jmips.verify_execution(domain, srs, JVesta, p, statement,
                                             JTestRng(seed + 1)))
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
    elif case in ("mips", "mips_cannon"):
        st = mips.statement_from_json(statement["statement"])
        assert mips.statement_to_json(st) == statement["statement"]
        cannon = case == "mips_cannon"
        program = snapshot_program(mips) if cannon else mips_program(mips)
        assert st["program"] == program
        kw = dict(pc0=SNAPSHOT_PC0, preimages=SNAPSHOT_PREIMAGES) if cannon else {}
        assert st["preimages"] == kw.get("preimages", {})
        rows, state = mips.execute(st["program"], n // 2, None,
                                   snapshot_memory() if cannon else None, **kw)
        assert st["k_steps"] == len(rows) and st["init_memory"] == state["init_memory"]
        assert st["init"] == {"pc": kw.get("pc0", 0), "hi": 0, "lo": 0, "heap": 0, "po": 0,
                              "pk": bytes(32)}
        assert st["final"] == {k: state[k] for k in (
            "regs", "pc", "hi", "lo", "memory", "last_access", "heap", "po", "pk", "exited",
            "exit_code")}
        if cannon:  # tests/test_mips.py's checks
            assert st["final"]["exited"] and st["final"]["exit_code"] == 3
            assert st["final"]["regs"][9] == 0x11223344 and st["final"]["pk"] == SNAPSHOT_KEY
        else:
            assert st["final"]["regs"][5] == 42
        logup = mips.make_logup(Vesta.scalar, st["program"], n, mips.Layout(2),
                                preimages=st["preimages"], pc0=st["init"]["pc"])
        ncols = logup.phase1_end + logup.num_phase2
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
