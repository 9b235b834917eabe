"""o1vm's RV32IM execution proof (o1vm/riscv.py) on the CPU, against the JAX
package's, at the inputs of tests/test_riscv.py (rich_program: one of every
instruction class; Layout(2); n = 256):
  - execute equals the JAX package's on rich_program and on the division
    conventions' programs, and decode on its words and on seeded words of
    every opcode;
  - build_columns, MultiLogup's phase1_columns and phase2_host (seeded beta
    and joint combiner), and the device make_phase2 columns (plain versions)
    equal the JAX package's; so does every constraint under eval_host at
    seeded cell values;
  - every constraint holds on every row of rich_program's trace with its
    phase-2 columns, checked by tests/test_torch_mips.py's host checker (the
    port's own expr.eval_host, with the boundary rows' Lagrange values on the
    domain);
  - a corrupted memory value makes phase2_host raise "does not hold", and a
    corrupted DIVU quotient fails the check.
Every comparison is exact. The proof itself runs on the card (chip_smoke.py,
tests/test_torch_cuda.py), against the JAX package's vector
(tests/test_torch_column_vectors.py)."""

import random

import numpy as np
import pytest
import torch

from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.o1vm import riscv as jriscv
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu_torch.circuits import expr as E
from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
from proof_systems_tpu_torch.convert import limbs_to_numpy
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.o1vm import riscv
from proof_systems_tpu_torch.ops import limb
from tests.test_riscv import rich_program as jrich_program
from tests.test_torch_mips import first_violation as mips_first_violation

P = Fp.p
N = 256
CPU = torch.device("cpu")
BETA, JOINT = 12345, 6789
OMEGA = EvaluationDomains.create(Fp, N, device=CPU).d1.group_gen


def port_program(program):
    return [riscv.Instr(i.op, i.rd, i.rs1, i.rs2, i.imm) for i in program]


def fields(instrs):
    return [(i.op, i.rd, i.rs1, i.rs2, i.imm) for i in instrs]


def test_execute_equals_jax():
    programs = [jrich_program(),
                [jriscv.Instr("DIV", rd=1, rs1=0, rs2=0), jriscv.Instr("ADDI", rd=2, rs1=0, imm=9),
                 jriscv.Instr("DIVU", rd=3, rs1=2, rs2=0), jriscv.Instr("REM", rd=4, rs1=2, rs2=0),
                 jriscv.Instr("REMU", rd=5, rs1=2, rs2=0)],
                [jriscv.Instr("LUI", rd=1, imm=0x80000), jriscv.Instr("ADDI", rd=2, rs1=0, imm=-1),
                 jriscv.Instr("DIV", rd=3, rs1=1, rs2=2), jriscv.Instr("REM", rd=4, rs1=1, rs2=2)]]
    for jprog in programs:
        rows, state = riscv.execute(port_program(jprog), 200)
        jrows, jstate = jriscv.execute(jprog, 200)
        assert state == jstate
        assert [{**r, "instr": fields([r["instr"]])} for r in rows] == [
            {**r, "instr": fields([r["instr"]])} for r in jrows]
    assert len(rows) == 4 and state["regs"][3] == 0x80000000


def test_decode_equals_jax():
    rng = random.Random(80)
    opcodes = [0x33, 0x13, 0x03, 0x23, 0x37, 0x17, 0x63, 0x6F, 0x67, 0x0F, 0x73]
    words = [0x002081B3, 0x40208233, 0xFFB08293, 0x4020D593, 0x02208633, 0x0040A803,
             0x0020A223, 0xDEAD0937, 0x008000EF, 0x00408067, 0x0020F463, 0x73, 0x100073]
    words += [(rng.getrandbits(25) << 7) | rng.choice(opcodes) for _ in range(2000)]
    words += [rng.getrandbits(32) for _ in range(200)]
    decoded = 0
    for w in words:
        try:
            got = fields([riscv.decode(w)])
        except ValueError as e:
            got = str(e)
        try:
            want = fields([jriscv.decode(w)])
        except ValueError as e:
            want = str(e)
        assert got == want, hex(w)
        decoded += not isinstance(got, str)
    assert decoded > 1000


@pytest.fixture(scope="module")
def rich():
    """rich_program's trace in both packages at n = 256, Layout(2)."""
    L, JL = riscv.Layout(2), jriscv.Layout(2)
    prog, jprog = port_program(jrich_program()), jrich_program()
    rows, state = riscv.execute(prog, N // 2)
    jrows, jstate = jriscv.execute(jprog, N // 2)
    cols = riscv.build_columns(Fp, rows, state, N, L)
    jcols = jriscv.build_columns(JFp, jrows, jstate, N, JL)
    lg, jlg = riscv.make_logup(Fp, prog, N, L), jriscv.make_logup(JFp, jprog, N, JL)
    full, jfull = lg.phase1_columns(cols), jlg.phase1_columns(jcols)
    return dict(L=L, prog=prog, rows=rows, state=state, cols=cols, jcols=jcols, lg=lg, jlg=jlg,
                full=full, jfull=jfull, phase2=lg.phase2_host(BETA, JOINT),
                cons=riscv.constraints(Fp, lg, len(rows), None, state, OMEGA, L),
                jcons=jriscv.constraints(JFp, jlg, len(jrows), None, jstate, OMEGA, JL))


def test_columns_and_lookups_equal_jax(rich):
    lg, jlg = rich["lg"], rich["jlg"]
    assert rich["L"].ncols == jriscv.Layout(2).ncols
    assert rich["cols"] == rich["jcols"]
    assert rich["full"] == rich["jfull"]
    assert (lg.phase1_end, lg.num_phase2, lg.h_cols, lg.phi_col, lg.m_col, lg.table_col) == (
        jlg.phase1_end, jlg.num_phase2, jlg.h_cols, jlg.phi_col, jlg.m_col, jlg.table_col)
    # at Layout(2): 299 trace columns, then 15 table and multiplicity columns in
    # phase 1; 60 lookup slots a row (the table slots among them); 11 phase-2
    # columns
    assert (rich["L"].ncols, len(rich["full"]), len(lg.specs), lg.num_phase2) == (
        299, 314, 60, 11)
    assert rich["phase2"] == jlg.phase2_host(BETA, JOINT)
    rng = random.Random(82)
    beta, joint = rng.randrange(P), rng.randrange(P)
    dev = lg.make_phase2(limb.device_field(Fp), CPU)(beta, joint)
    jdev = jlg.make_phase2(jlimb.device_field(JFp))(beta, joint)
    assert dev.shape == (limb.NLIMBS, 11, N)
    assert (limbs_to_numpy(dev) == np.asarray(jdev)).all()


def test_constraints_equal_jax(rich):
    cons, jcons = rich["cons"], rich["jcons"]
    assert len(cons) == len(jcons)
    rng = random.Random(83)
    ncols = len(rich["full"]) + len(rich["phase2"])
    cur = [rng.randrange(P) for _ in range(ncols)]
    nxt = [rng.randrange(P) for _ in range(ncols)]
    get = lambda c, row: cur[c[1]] if row == E.CURR else nxt[c[1]]  # noqa: E731
    kw = dict(get_cell=get, challenges={"alpha": 1, "beta": BETA, "gamma": 0,
                                        "joint_combiner": JOINT},
              endo=0, mds=[], point=rng.randrange(P), domain_n=N, omega=OMEGA, zk_rows=0)
    ctx, jctx = E.HostEvalContext(f=Fp, **kw), JE.HostEvalContext(f=JFp, **kw)
    assert [E.eval_host(c, ctx) for c in cons] == [JE.eval_host(c, jctx) for c in jcons]


def first_violation(allcols, cons, beta: int, joint: int):
    """(constraint, row) of the first constraint that does not vanish on a
    row of the n = 256 domain, or None (tests/test_torch_mips.py's checker:
    the port's expr.eval_host over arrays of every row)."""
    return mips_first_violation(allcols, cons, N, OMEGA, beta, joint)


def test_every_constraint_holds_on_every_row(rich):
    assert {r["instr"].op for r in rich["rows"]} == set(riscv.OPS)
    assert first_violation(rich["full"] + rich["phase2"], rich["cons"], BETA, JOINT) is None


def test_corrupt_memory_breaks_the_balance():
    """tests/test_riscv.py's corruption: a stored 42 read back as 43."""
    L = riscv.Layout(2)
    program = [riscv.Instr("ADDI", rd=1, rs1=0, imm=42), riscv.Instr("SW", rs1=0, rs2=1, imm=8),
               riscv.Instr("LW", rd=2, rs1=0, imm=8)]
    rows, state = riscv.execute(program, 10)
    cols = riscv.build_columns(Fp, rows, state, N, L)
    for ci in (L.mval, L.mold, L.mold_b[0], L.res, L.res_b[0]):
        cols[ci][2] = 43
    lg = riscv.make_logup(Fp, program, N, L)
    lg.phase1_columns(cols)
    with pytest.raises(ValueError, match="does not hold"):
        lg.phase2_host(777, 888)


def test_corrupt_div_quotient_fails_the_check():
    """A wrong DIVU quotient (14 for 96 / 7) violates the Euclidean identity."""
    L = riscv.Layout(2)
    program = [riscv.Instr("ADDI", rd=1, rs1=0, imm=96), riscv.Instr("ADDI", rd=2, rs1=0, imm=7),
               riscv.Instr("DIVU", rd=3, rs1=1, rs2=2)]
    rows, state = riscv.execute(program, N // 2)
    lg = riscv.make_logup(Fp, program, N, L)
    full = lg.phase1_columns(riscv.build_columns(Fp, rows, state, N, L))
    allcols = full + lg.phase2_host(BETA, JOINT)
    cons = riscv.constraints(Fp, lg, len(rows), None, state, OMEGA, L)
    assert first_violation(allcols, cons, BETA, JOINT) is None
    allcols[L.qq][2] = 14
    k, row = first_violation(allcols, cons, BETA, JOINT)
    assert row == 2


def test_chip_smoke_loop_program_holds_every_constraint():
    """chip_smoke.py's full-width program: at n = 2^15 it runs its n / 2
    steps inside the domain, through every instruction; at n = 256 its trace
    (128 steps, Layout(2)) holds every constraint and lookup, in the JAX
    package's columns too."""
    import chip_smoke

    program = chip_smoke.rv_loop_program()
    n = 1 << chip_smoke.RV_LOG_N
    rows, state = riscv.execute(program, n // 2)
    assert len(rows) == n // 2 and len(rows) + 1 + len(state["init_memory"]) <= n
    assert {r["instr"].op for r in rows} == set(riscv.OPS)
    assert any(r["instr"].op == "DIVU" and r["regs"][18] == 0 for r in rows)

    L = riscv.Layout(2)
    rows, state = riscv.execute(program, N // 2)
    assert {r["instr"].op for r in rows} == set(riscv.OPS)
    lg = riscv.make_logup(Fp, program, N, L)
    full = lg.phase1_columns(riscv.build_columns(Fp, rows, state, N, L))
    jprog = [jriscv.Instr(*fields([i])[0]) for i in program]
    jrows, jstate = jriscv.execute(jprog, N // 2)
    jfull = jriscv.make_logup(JFp, jprog, N, jriscv.Layout(2)).phase1_columns(
        jriscv.build_columns(JFp, jrows, jstate, N, jriscv.Layout(2)))
    assert full == jfull
    cons = riscv.constraints(Fp, lg, len(rows), None, state, OMEGA, L)
    assert first_violation(full + lg.phase2_host(BETA, JOINT), cons, BETA, JOINT) is None
