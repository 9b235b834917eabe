"""o1vm's MIPS execution proof (o1vm/mips.py) on the CPU, against the JAX
package's, at the inputs of tests/test_mips.py (Layout(2)):
  - execute equals the JAX package's (rows and state) on fib_program,
    rich_program, cannon_ext_program (heap0 = 0x20000000), preimage_program
    over its memory and preimages, and the Cannon snapshot segment of
    tests/test_torch_column_vectors.py (pc0 = 0x1000); decode equals it on
    the words of those programs (tests/test_mips.py's _encode) and on seeded
    words of every opcode, and chip_smoke.mips_encode is _encode;
  - on four traces (rich_program at n = 256; cannon_ext_program,
    preimage_program and chip_smoke.mips_loop_program at n = 512),
    build_columns, MultiLogup's phase1_columns and phase2_host (seeded beta
    and joint combiner) and every constraint under eval_host at seeded cell
    values equal the JAX package's, and every constraint holds on every row
    (this file's host checker: the port's own expr.eval_host, with the
    boundary rows' Lagrange values on the domain); the device make_phase2
    columns (plain versions) equal the JAX package's on rich_program;
  - tests/test_mips.py's negatives: a wrong preimage stream byte and a
    wrong AND chunk are not in their tables, a wrong loaded word breaks the
    memory balance.
Every comparison is exact. The proofs themselves run on the card
(chip_smoke.py, tests/test_torch_cuda.py), against the JAX package's vectors
(tests/test_torch_column_vectors.py)."""

import random

import numpy as np
import pytest
import torch

import chip_smoke
from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.o1vm import mips as jmips
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu_torch.circuits import expr as E
from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
from proof_systems_tpu_torch.convert import limbs_to_numpy
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.o1vm import mips
from proof_systems_tpu_torch.ops import limb
from tests.test_mips import PREIMAGES, _encode, _preimage_memory, cannon_ext_program, fib_program
from tests.test_mips import preimage_program, rich_program
from tests.test_torch_column_vectors import (
    SNAPSHOT_PC0,
    SNAPSHOT_PREIMAGES,
    snapshot_memory,
    snapshot_program,
)

P = Fp.p
CPU = torch.device("cpu")
BETA, JOINT = 12345, 6789


def port_program(program):
    return [mips.Instr(i.op, i.rd, i.rs, i.rt, i.imm) for i in program]


def jax_program(program):
    return [jmips.Instr(i.op, i.rd, i.rs, i.rt, i.imm) for i in program]


def fields(instrs):
    return [(i.op, i.rd, i.rs, i.rt, i.imm) for i in instrs]


# (program in the JAX package's Instr, max_steps, execute's keywords)
PROGRAMS = {
    "fib": (lambda: fib_program(8), 100, {}),
    "rich": (rich_program, 200, {}),
    "cannon_ext": (cannon_ext_program, 400, {"heap0": 0x20000000}),
    "preimage": (preimage_program, 200, {"memory": _preimage_memory(), "preimages": PREIMAGES}),
    "snapshot": (lambda: snapshot_program(jmips), 100,
                 {"memory": snapshot_memory(), "pc0": SNAPSHOT_PC0,
                  "preimages": SNAPSHOT_PREIMAGES}),
}


def run_both(jprog, steps, kw):
    rows, state = mips.execute(port_program(jprog), steps, **kw)
    jrows, jstate = jmips.execute(jprog, steps, **kw)
    return rows, state, jrows, jstate


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_execute_equals_jax(name):
    make, steps, kw = PROGRAMS[name]
    rows, state, jrows, jstate = run_both(make(), steps, kw)
    assert state == jstate
    assert [{**r, "instr": fields([r["instr"]])} for r in rows] == [
        {**r, "instr": fields([r["instr"]])} for r in jrows]
    if name == "cannon_ext":  # tests/test_mips.py's checks
        assert state["exited"] and state["exit_code"] == 7
        assert state["heap"] == 0x20000000 + 8192 and state["regs"][25] == 1
    if name == "preimage":
        assert state["pk"] == bytes(range(2, 34)) and state["po"] == 14


def test_decode_equals_jax():
    rng = random.Random(90)
    words = [_encode(i) for make, _, _ in PROGRAMS.values() for i in make()]
    # every primary opcode with random fields, every funct of opcode 0 and
    # every rt of REGIMM, then random words
    words += [(op << 26) | rng.getrandbits(26) for op in range(64) for _ in range(40)]
    words += [(rng.getrandbits(20) << 6) | funct for funct in range(64) for _ in range(10)]
    words += [(1 << 26) | (rng.getrandbits(5) << 21) | (rt << 16) | rng.getrandbits(16)
              for rt in range(32) for _ in range(5)]
    words += [rng.getrandbits(32) for _ in range(500)]
    decoded = 0
    for w in words:
        try:
            got = fields([mips.decode(w)])
        except ValueError as e:
            got = str(e)
        try:
            want = fields([jmips.decode(w)])
        except ValueError as e:
            want = str(e)
        assert got == want, hex(w)
        decoded += not isinstance(got, str)
    assert decoded > 1500


def test_chip_smoke_encode_is_the_tests_encode():
    """chip_smoke.mips_encode (the Cannon phase's assembler) is
    tests/test_mips.py's _encode on one instruction of every op, and decode
    inverts it."""
    prog = chip_smoke.mips_loop_program(256) + port_program(cannon_ext_program())
    assert {i.op for i in prog} == set(mips.OPS)
    for ins in prog:
        word = chip_smoke.mips_encode(ins)
        assert word == _encode(jmips.Instr(*fields([ins])[0]))
        if ins.op not in ("SYSCALL", "SYNC"):
            assert fields([mips.decode(word)]) == fields([ins])


# the traces held against the JAX package: (program, n, execute's keywords,
# constraints' init)
TRACES = {
    "rich": (lambda: port_program(rich_program()), 256, {}, None),
    "cannon_ext": (lambda: port_program(cannon_ext_program()), 512, {"heap0": 0x20000000},
                   {"heap": 0x20000000}),
    "preimage": (lambda: port_program(preimage_program()), 512,
                 {"memory": _preimage_memory(), "preimages": PREIMAGES}, None),
    "loop": (lambda: chip_smoke.mips_loop_program(256), 512,
             {"preimages": chip_smoke.MIPS_PREIMAGES}, None),
}


@pytest.fixture(scope="module", params=sorted(TRACES))
def trace(request):
    """A trace in both packages at Layout(2): columns, phase 1 and phase 2,
    the constraints."""
    make, n, kw, init = TRACES[request.param]
    L, JL = mips.Layout(2), jmips.Layout(2)
    prog = make()
    jprog = jax_program(prog)
    rows, state, jrows, jstate = run_both(jprog, n // 2, kw)
    omega = EvaluationDomains.create(Fp, n, device=CPU).d1.group_gen
    pre = kw.get("preimages")
    lg = mips.make_logup(Fp, prog, n, L, preimages=pre)
    jlg = jmips.make_logup(JFp, jprog, n, JL, preimages=pre)
    cols = mips.build_columns(Fp, rows, state, n, L)
    jcols = jmips.build_columns(JFp, jrows, jstate, n, JL)
    full, jfull = lg.phase1_columns(cols), jlg.phase1_columns(jcols)
    return dict(name=request.param, n=n, L=L, prog=prog, rows=rows, state=state, omega=omega,
                cols=cols, jcols=jcols, lg=lg, jlg=jlg, full=full, jfull=jfull,
                phase2=lg.phase2_host(BETA, JOINT), jphase2=jlg.phase2_host(BETA, JOINT),
                cons=mips.constraints(Fp, lg, len(rows), None, state, omega, L, init),
                jcons=jmips.constraints(JFp, jlg, len(jrows), None, jstate, omega, JL, init))


def test_columns_and_lookups_equal_jax(trace):
    lg, jlg = trace["lg"], trace["jlg"]
    assert trace["cols"] == trace["jcols"]
    assert trace["full"] == trace["jfull"]
    assert trace["phase2"] == trace["jphase2"]
    assert (lg.phase1_end, lg.num_phase2, lg.h_cols, lg.phi_col, lg.m_col, lg.table_col) == (
        jlg.phase1_end, jlg.num_phase2, jlg.h_cols, jlg.phi_col, jlg.m_col, jlg.table_col)
    # at Layout(2): 379 trace columns, 404 after phase 1 (six tables and
    # their multiplicities); 70 lookup slots a row (the six tables' among
    # them), 13 phase-2 columns
    assert (trace["L"].ncols, len(trace["full"]), len(lg.specs), lg.num_phase2) == (
        379, 404, 70, 13)
    if trace["name"] == "rich":
        rng = random.Random(92)
        beta, joint = rng.randrange(P), rng.randrange(P)
        dev = lg.make_phase2(limb.device_field(Fp), CPU)(beta, joint)
        jdev = jlg.make_phase2(jlimb.device_field(JFp))(beta, joint)
        assert dev.shape == (limb.NLIMBS, 13, trace["n"])
        assert (limbs_to_numpy(dev) == np.asarray(jdev)).all()


def test_constraints_equal_jax(trace):
    cons, jcons = trace["cons"], trace["jcons"]
    assert len(cons) == len(jcons)
    if trace["name"] == "rich":
        assert len(cons) == 545  # at n = 256, Layout(2)
    rng = random.Random(93)
    ncols = len(trace["full"]) + len(trace["phase2"])
    cur = [rng.randrange(P) for _ in range(ncols)]
    nxt = [rng.randrange(P) for _ in range(ncols)]
    get = lambda c, row: cur[c[1]] if row == E.CURR else nxt[c[1]]  # noqa: E731
    kw = dict(get_cell=get, challenges={"alpha": 1, "beta": BETA, "gamma": 0,
                                        "joint_combiner": JOINT},
              endo=0, mds=[], point=rng.randrange(P), domain_n=trace["n"],
              omega=trace["omega"], zk_rows=0)
    ctx, jctx = E.HostEvalContext(f=Fp, **kw), JE.HostEvalContext(f=JFp, **kw)
    assert [E.eval_host(c, ctx) for c in cons] == [JE.eval_host(c, jctx) for c in jcons]


def first_violation(allcols, cons, n: int, omega: int, beta: int, joint: int, expr=E, f=Fp):
    """(constraint, row) of the first constraint that does not vanish on a
    row of the domain (rows in order, then constraints; rows cyclic), or
    None. Each constraint goes through expr.eval_host once, on numpy arrays
    of Python integers that hold every row's cell values (the constraints
    have no Pow node); each boundary row's UnnormalizedLagrangeBasis(i)
    takes its value on the domain, n * w^-i at row i and 0 elsewhere. `expr`
    and `f` are the port's expr module and field, or the JAX package's."""
    offsets = set()
    stack, seen = list(cons), set()
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, expr.UnnormalizedLagrangeBasis):
            offsets.add(e.offset % n)
        stack.extend(c for c in (getattr(e, "a", None), getattr(e, "b", None))
                     if isinstance(c, expr.Expr))
    shifted = {}

    def get_cell(c, row):
        if (c[1], row) not in shifted:
            colv = allcols[c[1]]
            shifted[c[1], row] = np.array(colv[row:] + colv[:row], dtype=object)
        return shifted[c[1], row]

    def lagrange(i):
        v = np.zeros(n, dtype=object)
        v[i] = n * pow(omega, (n - i) % n, P) % P
        return v

    ctx = expr.HostEvalContext(
        f=f, get_cell=get_cell,
        challenges={"alpha": 1, "beta": beta, "gamma": 0, "joint_combiner": joint},
        endo=0, mds=[], point=0, domain_n=n, omega=omega, zk_rows=0,
        lagrange_overrides={i: lagrange(i) for i in offsets})
    memo: dict = {}
    first = [(int(np.flatnonzero(np.broadcast_to(v, (n,)) != 0)[0]), k) for k, v in (
        (k, expr.eval_host(con, ctx, memo)) for k, con in enumerate(cons)) if np.any(v != 0)]
    return None if not first else min(first)[::-1]


def test_every_constraint_holds_on_every_row(trace):
    rows = trace["rows"]
    if trace["name"] == "loop":
        # chip_smoke's full-width program: every op and every syscall kind,
        # exit_group on its last step
        assert {r["instr"].op for r in rows} == set(mips.OPS)
        assert {r["sys_kind"] for r in rows if "sys_kind" in r} == set(mips.SYS_KINDS)
        assert len(rows) == trace["n"] // 2 and trace["state"]["exited"]
        assert rows[-1]["sys_kind"] == "exit"
    assert first_violation(trace["full"] + trace["phase2"], trace["cons"], trace["n"],
                           trace["omega"], BETA, JOINT) is None


def test_chip_smoke_loop_program_fits_its_domains():
    """At chip_smoke's domains the loop runs its n / 2 steps to exit_group
    inside the domain with its boundary rows, every op and syscall kind on
    the path, and its tables (the ROM, Layout(4)'s 1,024-entry bitwise
    table, the preimage stream) fit n."""
    for log_n in (chip_smoke.MIPS_COMBINED_LOG_N, chip_smoke.MIPS_LOG_N):
        n = 1 << log_n
        program = chip_smoke.mips_loop_program(n // 2)
        rows, state = mips.execute(program, n // 2, preimages=chip_smoke.MIPS_PREIMAGES)
        assert len(rows) == n // 2 and state["exited"] and state["exit_code"] == 3
        assert len(rows) + 1 + len(state["init_memory"]) <= n
        assert {r["instr"].op for r in rows} == set(mips.OPS)
        assert {r["sys_kind"] for r in rows if "sys_kind" in r} == set(mips.SYS_KINDS)
        lg = mips.make_logup(Fp, program, n, mips.LAYOUT, preimages=chip_smoke.MIPS_PREIMAGES)
        assert max(len(t.columns[0]) for t in lg.tables) <= n
    assert any(r["instr"].op == "DIV" and r["flag"] for r in rows)  # by zero at 2^14


@pytest.mark.parametrize("log_n", [chip_smoke.MIPS_COMBINED_LOG_N, chip_smoke.MIPS_LOG_N,
                                   chip_smoke.MIPS_LOG_N + 1])
def test_chip_smoke_loop_program_holds_every_constraint_at_full_width(log_n):
    """At the card's domains and the default Layout(4), the loop program's
    n / 2 steps hold every constraint on every row (so its proof there has a
    zero quotient remainder)."""
    n, L = 1 << log_n, mips.LAYOUT
    program = chip_smoke.mips_loop_program(n // 2)
    rows, state = mips.execute(program, n // 2, preimages=chip_smoke.MIPS_PREIMAGES)
    lg = mips.make_logup(Fp, program, n, L, preimages=chip_smoke.MIPS_PREIMAGES)
    allcols = lg.phase1_columns(mips.build_columns(Fp, rows, state, n, L))
    omega = EvaluationDomains.create(Fp, n, device=CPU).d1.group_gen
    cons = mips.constraints(Fp, lg, len(rows), None, state, omega, L)
    assert first_violation(allcols + lg.phase2_host(BETA, JOINT), cons, n, omega, BETA,
                           JOINT) is None


def test_corrupt_preimage_byte_not_in_table():
    """A preimage-read row claiming a wrong stream byte is not in the
    PREIMAGE table."""
    n, L = 512, mips.Layout(2)
    program = port_program(preimage_program())
    rows, state = mips.execute(program, 200, memory=_preimage_memory(), preimages=PREIMAGES)
    cols = mips.build_columns(Fp, rows, state, n, L)
    i = next(j for j, row in enumerate(rows) if row.get("sys_kind") == "rpre" and row.get("n", 0))
    cols[L.sb[0]][i] = (cols[L.sb[0]][i] + 1) % 256
    lg = mips.make_logup(Fp, program, n, L, preimages=PREIMAGES)
    with pytest.raises(ValueError, match="not in table"):
        lg.phase1_columns(cols)


def test_corrupt_memory_breaks_the_balance():
    """A stored 42 read back as 43: the memory multiset does not balance."""
    n, L = 256, mips.Layout(2)
    program = [mips.Instr("ADDIU", rt=1, rs=0, imm=42), mips.Instr("SW", rt=1, rs=0, imm=8),
               mips.Instr("LW", rt=2, rs=0, imm=8)]
    rows, state = mips.execute(program, 10)
    cols = mips.build_columns(Fp, rows, state, n, L)
    for ci in (L.mval, L.res, L.res_b[0]):
        cols[ci][2] = 43
    lg = mips.make_logup(Fp, program, n, L)
    lg.phase1_columns(cols)
    with pytest.raises(ValueError, match="does not hold"):
        lg.phase2_host(777, 888)


def test_corrupt_bitwise_not_in_table():
    """A wrong AND chunk (6 & 7 claimed to have low chunk 3) is not in the
    bitwise table."""
    n, L = 256, mips.Layout(2)
    program = [mips.Instr("ADDIU", rt=1, rs=0, imm=6), mips.Instr("ADDIU", rt=2, rs=0, imm=7),
               mips.Instr("AND", rd=3, rs=1, rt=2)]
    rows, state = mips.execute(program, 10)
    cols = mips.build_columns(Fp, rows, state, n, L)
    cols[L.zn[0]][2] = 3
    lg = mips.make_logup(Fp, program, n, L)
    with pytest.raises(ValueError, match="not in table"):
        lg.phase1_columns(cols)


def load_trace(pkg, field, expr, op: str, value: int, n: int = 256):
    """The columns (phases 1 and 2) and constraints of a store of `value` at
    address 8 and one sub-word load `op` of it, in the package `pkg`."""
    I = pkg.Instr  # noqa: E741
    off = {"LB": 11, "LBU": 11, "LH": 10, "LHU": 10}
    program = [I("ORI", rt=1, rs=0, imm=value), I("SW", rt=1, rs=0, imm=8)]
    program += [I(o, rt=2 + k, rs=0, imm=off[o]) for k, o in enumerate(op.split("+"))]
    rows, state = pkg.execute(program, 10)
    L = pkg.Layout(2)
    lg = pkg.make_logup(field, program, n, L)
    allcols = lg.phase1_columns(pkg.build_columns(field, rows, state, n, L))
    allcols += lg.phase2_host(BETA, JOINT)
    omega = EvaluationDomains.create(Fp, n, device=CPU).d1.group_gen
    cons = pkg.constraints(field, lg, len(rows), None, state, omega, L)
    return first_violation(allcols, cons, n, omega, BETA, JOINT, expr, field), rows


@pytest.mark.parametrize("op,value", [("LBU", 0x80), ("LHU", 0x8000)])
def test_unsigned_subword_load_of_a_set_top_bit_breaks_a_constraint_in_both(op, value):
    """A fault of the JAX package, ported as it is: LBU and LHU run the
    sign-bit range check of LB and LH (auxc = 2 * (lbv - 2^7 or 2^15 * sbit)
    in one or two bytes) with sbit forced to 0, so an honest load of a byte
    from 0x80 or a halfword from 0x8000 leaves that constraint unsatisfied,
    in both packages at the same constraint and row. LB and LH of the same
    values hold (test below)."""
    got, rows = load_trace(mips, Fp, E, op, value)
    want, _ = load_trace(jmips, JFp, JE, op, value)
    assert rows[2]["res"] == value
    assert got == want and got[1] == 2


def test_signed_subword_loads_of_a_set_top_bit_hold():
    """LB of the byte 0x80 and LH of the halfword 0x8000 (sign-extended)."""
    got, rows = load_trace(mips, Fp, E, "LB+LH", 0x8080)
    assert [r["res"] for r in rows[2:]] == [0xFFFFFF80, 0xFFFF8080]
    assert got is None
