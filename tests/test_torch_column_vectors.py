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
    Layout(2), n = 512, TestRng(81));
  - column_msm_2^8: tests/test_msm_circuit.py's foreign-field MSM proof
    (TOY_LAYOUT, scalars [11, 6], toy_points(2), n = 256, TestRng(41));
  - column_ivc_vesta_2^8 and column_ivc_pallas_2^8: the two decider proofs
    of tests/test_ivc.py's full-circuit IVC (n = 256, TestRng(9), two steps,
    `decide` with TestRng(10)), over Vesta / Fp and Pallas / Fq.
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

from proof_systems_tpu import msm_circuit as jmsm
from proof_systems_tpu.circuits.domains import EvaluationDomains as JEvaluationDomains
from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.fields import Fq as JFq
from proof_systems_tpu.folding import arrabbiata as jarrabbiata
from proof_systems_tpu.folding import ivc as jivc
from proof_systems_tpu.o1vm import keccak as jkeccak
from proof_systems_tpu.o1vm import mips as jmips
from proof_systems_tpu.o1vm import pickles as jpickles
from proof_systems_tpu.o1vm import riscv as jriscv
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poly_commitment.commitment import PolyComm as JPolyComm
from proof_systems_tpu.poly_commitment.ipa import OpeningProof as JOpeningProof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch.convert import column_proof_fields, column_proof_from_fields
from proof_systems_tpu_torch import msm_circuit
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.folding import ivc
from proof_systems_tpu_torch.o1vm import keccak, mips, pickles, riscv
from proof_systems_tpu_torch.poseidon.params import fp_3_60_0_5_5, fq_3_60_0_5_5
from tests.test_msm_circuit import TOY, TOY_LAYOUT, toy_points
from proof_systems_tpu_torch.serialization import (
    deserialize_column_proof,
    serialize_column_proof,
)

VECTORS = pathlib.Path(__file__).parent / "vectors"
JCLASSES = (jpickles.ColumnProof, JPolyComm, JOpeningProof)
CASES = {"keccak": ("column_keccak_2^5", 32), "riscv": ("column_riscv_2^8", 256),
         "mips": ("column_mips_2^8", 256), "mips_cannon": ("column_mips_cannon_2^9", 512),
         "msm": ("column_msm_2^8", 256), "ivc_vesta": ("column_ivc_vesta_2^8", 256),
         "ivc_pallas": ("column_ivc_pallas_2^8", 256)}
CURVES = {"ivc_pallas": Pallas}  # the proof's curve, where it is not Vesta
MSM_SCALARS = [11, 6]
IVC_STEPS, IVC_Z0 = 2, 2


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


def jax_ivc_deciders(n: int):
    """tests/test_ivc.py's heavy statement in the JAX package: the IVC over
    both curves (TestRng(9), IVC_STEPS steps from z = IVC_Z0), then
    IVC.decide's loop with TestRng(10), keeping each side's decider proof:
    [(proof, statement, verify)] for Vesta, then Pallas."""
    def make_srs(curve):
        return jsrs.SRS(curve, [jsrs.derive_g(curve, i) for i in range(n)], jsrs.derive_h(curve))

    iv = jivc.IVC(make_srs(JVesta), make_srs(JPallas), n=n, rng=JTestRng(9))
    z = iv.run(IVC_Z0, steps=IVC_STEPS)
    rng = JTestRng(10)
    out = []
    for side in iv.sides:
        assert side.env.is_satisfied(side.acc) and side.scheme.check_commitments(side.acc)
        assert iv.check_fixed_pinning(side)
        domain = JEvaluationDomains.create(side.field, n)
        srs = side.scheme.srs
        proof, cons = jarrabbiata.decider_prove(side.env, side.acc, domain, srs, side.curve, rng)

        def verify(p, side=side, cons=cons, domain=domain, srs=srs, seed=[11]):
            seed[0] += 1
            return jarrabbiata.decider_verify(side.env, p, cons, domain, srs, side.curve,
                                              JTestRng(seed[0]))

        assert jarrabbiata.decider_verify(side.env, proof, cons, domain, srs, side.curve, rng)
        statement = {"n": n, "curve": side.curve.name, "steps": IVC_STEPS, "z0": IVC_Z0, "z": z,
                     "digests": iv.digests, "u": side.acc.u, "alphas": side.acc.alphas,
                     "kappa": side.kappa}
        out.append((proof, statement, verify))
    return out


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
    if case == "msm":
        proof, result = jmsm.prove_msm(domain, srs, JVesta, TOY, MSM_SCALARS, toy_points(2),
                                       JTestRng(41), L=TOY_LAYOUT)
        statement = {"n": n, "layout": [TOY_LAYOUT.lb, TOY_LAYOUT.fbits],
                     "curve": [TOY.f, TOY.a, TOY.b], "scalars": MSM_SCALARS,
                     "points": [list(pt) for pt in toy_points(2)], "result": list(result)}
        return proof, statement, (
            lambda p: jmsm.verify_msm(domain, srs, JVesta, TOY, MSM_SCALARS, toy_points(2),
                                      result, p, JTestRng(42), L=TOY_LAYOUT))
    if case in ("ivc_vesta", "ivc_pallas"):
        return jax_ivc_deciders(n)[case == "ivc_pallas"]
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
    curve = CURVES.get(case, Vesta)
    raw = serialize_column_proof(curve, column_proof_fields(proof))
    text = json.dumps(statement, sort_keys=True) + "\n"
    bin_path, json_path = paths(case)
    for path, data in ((bin_path, raw), (json_path, text.encode())):
        if not path.exists():
            path.write_bytes(data)
    assert raw == bin_path.read_bytes()
    assert json.loads(json_path.read_text()) == json.loads(text)
    fields = deserialize_column_proof(curve, bin_path.read_bytes())
    assert verify(column_proof_from_fields(fields, JCLASSES))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vector_loads_into_the_port_and_round_trips(case):
    bin_path, json_path = paths(case)
    raw = bin_path.read_bytes()
    curve = CURVES.get(case, Vesta)
    proof = column_proof_from_fields(deserialize_column_proof(curve, raw))
    assert isinstance(proof, pickles.ColumnProof)
    assert serialize_column_proof(curve, column_proof_fields(proof)) == raw
    statement = json.loads(json_path.read_text())
    n = statement["n"]
    assert n == CASES[case][1]
    if case == "keccak":
        ncols = keccak.LAYOUT.ncols + 65  # the bit columns, selector, round constants
        assert statement["state0"] == keccak_state0()
        assert statement["final"] == keccak.keccak_f(statement["state0"])
    elif case == "msm":
        fcurve = msm_circuit.ForeignCurve(*statement["curve"])
        layout = msm_circuit.Layout(*statement["layout"])
        assert fcurve == msm_circuit.ForeignCurve(TOY.f, TOY.a, TOY.b)
        points = [tuple(pt) for pt in statement["points"]]
        assert statement["scalars"] == MSM_SCALARS and points == toy_points(2)
        start, ops = msm_circuit.plan_msm(fcurve, statement["scalars"], points)
        _, result = msm_circuit.execute(fcurve, start, ops)
        assert list(result) == statement["result"]
        logup = msm_circuit.make_logup(Vesta.scalar, n, layout)
        ncols = logup.phase1_end + logup.num_phase2
    elif case in ("ivc_vesta", "ivc_pallas"):
        assert statement["curve"] == curve.name and statement["steps"] == IVC_STEPS
        field, params = (Fq, fq_3_60_0_5_5) if curve is Pallas else (Fp, fp_3_60_0_5_5)
        z = IVC_Z0
        for i in range(IVC_STEPS):  # z squared a step, over Fp then Fq
            z = z * z % (Fp, Fq)[i % 2].p
        assert statement["z"] == z and len(statement["digests"]) == IVC_STEPS
        # the first step absorbs zeros: the other side has no accumulator yet
        _, _, digest = ivc.build_step_trace(Fp, fp_3_60_0_5_5, IVC_Z0, [0] * 30, n)
        assert statement["digests"][0] == digest
        assert len(statement["alphas"]) == len(ivc.ivc_constraints(field, params))
        ncols = ivc.NCOLS + 1  # the accumulated columns and the error column
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
