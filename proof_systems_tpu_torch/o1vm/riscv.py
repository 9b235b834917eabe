"""RISC-V RV32IM execution proofs over the column prover, on the card.

Counterpart of proof_systems_tpu/o1vm/riscv.py. The host code (the
interpreter, the decoder, the witness columns, the lookup specs and the
constraint AST) is the JAX package's, copied as it is (the same dict and
list orders); the columns are packed on the device the caller names (the
card unless device="cpu") and prove through o1vm/pickles.prove_columns with
LogUp's phase-2 columns (o1vm/logup.MultiLogup, host code).

The reference proves RV32IM traces with a scratch-column interpreter
evaluated in two modes (o1vm/src/interpreters/riscv32im/, 4,885 LoC:
witness mode fills columns, constraint mode emits Expr), leaving
bitwise/div/mod results as unconstrained "unsafe" hints
(interpreter.rs:1270-1336). This module keeps the dual-interpretation
architecture, covers the FULL RV32IM instruction set, and constrains
every result:

  - program ROM pinning, byte range tables, bitwise chunk tables and
    the offline memory-checking RAM argument are shared with the MIPS
    interpreter's design (logup.MultiLogup);
  - memory is BYTE-addressed: word-keyed RAM records plus a byte-offset
    one-hot select/insert sub-word values for LB/LH/SB/SH (the
    reference models sub-word accesses the same way via its memory
    lookup environment);
  - the M extension is fully constrained: MUL/MULH/MULHSU/MULHU via
    sign-decomposed 64-bit product identities, DIV/DIVU/REM/REMU via
    magnitude Euclidean identities with remainder bounds and the
    RISC-V div-by-zero/overflow conventions (spec-complete, beyond the
    reference's hint-only treatment).

Statement proved: "running program P for k steps from public initial
state (pc=0, regs0, memory0) yields public final state", with the
boundary rows pinned.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circuits import expr as E
from ..fields import FieldParams
from ..runtime import resolve_device
from .logup import (
    BITWISE_OR,
    BITWISE_XOR,
    FixedTable,
    LookupSpec,
    MultiLogup,
    bitwise_table,
)

TWO32 = 1 << 32

OPS = [
    # RV32I register/immediate ALU
    "ADD", "SUB", "SLT", "SLTU", "XOR", "OR", "AND",
    "ADDI", "SLTI", "SLTIU", "XORI", "ORI", "ANDI",
    "SLL", "SRL", "SRA", "SLLI", "SRLI", "SRAI",
    "LUI", "AUIPC",
    # control transfer
    "JAL", "JALR", "BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU",
    # memory
    "LB", "LH", "LW", "LBU", "LHU", "SB", "SH", "SW",
    # M extension
    "MUL", "MULH", "MULHSU", "MULHU", "DIV", "DIVU", "REM", "REMU",
    # system (no-ops at this level)
    "FENCE", "ECALL",
]
OP_ID = {op: i for i, op in enumerate(OPS)}

R_BITWISE = ["XOR", "OR", "AND"]
I_BITWISE = ["XORI", "ORI", "ANDI"]
BITWISE = R_BITWISE + I_BITWISE
VAR_SHIFTS = ["SLL", "SRL", "SRA"]
CONST_SHIFTS = ["SLLI", "SRLI", "SRAI"]
SHIFTS = VAR_SHIFTS + CONST_SHIFTS
LOADS = ["LB", "LH", "LW", "LBU", "LHU"]
STORES = ["SB", "SH", "SW"]
MEM_OPS = LOADS + STORES
BRANCHES = ["BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU"]
DIVS = ["DIV", "DIVU", "REM", "REMU"]
MULHS = ["MULH", "MULHSU", "MULHU"]
NOOPS = ["FENCE", "ECALL"]

# ops whose rd is written with res
WRITING_OPS = [op for op in OPS if op not in BRANCHES + STORES + NOOPS]
# ops needing msb of rs1 (signed semantics)
MSB_A_OPS = ["SLT", "SLTI", "BLT", "BGE", "MULH", "MULHSU", "DIV", "REM", "SRA", "SRAI"]
# ops needing msb of rs2
MSB_B_OPS = ["SLT", "BLT", "BGE", "MULH", "DIV", "REM"]

TBL_BYTE = 3
TBL_BITWISE = 20
TBL_POW2 = 21
TBL_ROM = 23
TBL_MEMORY = 7

_BITWISE_OPID = {
    "AND": 0, "ANDI": 0, "OR": BITWISE_OR, "ORI": BITWISE_OR,
    "XOR": BITWISE_XOR, "XORI": BITWISE_XOR,
}


@dataclass
class Instr:
    op: str
    rd: int = 0
    rs1: int = 0
    rs2: int = 0
    imm: int = 0


class Layout:
    """Column layout; `bitwise_bits` is the width of a bitwise-table chunk
    (32 / bitwise_bits chunks a word)."""

    def __init__(self, bitwise_bits: int = 4):
        assert 32 % bitwise_bits == 0
        self.bw_bits = bitwise_bits
        nbw = 32 // bitwise_bits
        i = 0

        def take(k=1):
            nonlocal i
            out = list(range(i, i + k))
            i += k
            return out if k > 1 else out[0]

        self.pc = take()
        self.regs = take(32)
        self.sel = {}
        for op in OPS:
            self.sel[op] = take()
        self.rd_oh = take(32)
        self.rs1_oh = take(32)
        self.rs2_oh = take(32)
        self.imm = take()
        self.res = take()
        self.flag = take()    # carry / borrow / branch-compare / product sign
        self.inv = take()     # branch equality inverse
        self.idx = take()     # time counter (row j -> j + 1)
        self.pw = take()      # 2^sa (POW2-pinned)
        self.pw2b = take()    # 2^{32-sa}
        self.sa = take()      # shift amount
        self.shq = take()     # (rs1v - sa)/32 for register shifts
        self.msb_a = take()
        self.msb_b = take()
        self.imm32 = take()   # imm mod 2^32 (SLTI/SLTIU/bitwise-imm)
        self.ineg = take()    # immediate sign bit
        # division family
        self.qq = take()      # |quotient|
        self.rr = take()      # |remainder|
        self.bz = take()      # divisor == 0
        self.ibz = take()     # 1/rs2v when nonzero
        self.nzq = take()     # qq != 0
        self.iqq = take()
        self.nzr = take()     # rr != 0
        self.irr = take()
        # JALR / AUIPC helpers
        self.jt = take()      # JALR target (even)
        self.jt2 = take()     # half of jt's low byte (evenness witness)
        self.jlsb = take()    # dropped low bit
        self.jcarry = take()  # {-1,0,1} wrap
        self.acar = take()    # AUIPC carry bit
        # byte groups (all byte-table checked every row)
        self.res_b = take(4)
        self.auxa_b = take(4)  # flag(shifts) | d(cmp/branch) | hi(MUL) |
        #                        lo(MULH*) | qq(div) | jt(JALR)
        self.auxb_b = take(4)  # msb_a tie | flag*pw2b (shifts) | elapsed(mem)
        self.auxc_b = take(4)  # msb_b tie
        self.auxd_b = take(4)  # shq | imm32 | (bb-rr-1) bound (div)
        self.wa_b = take(4)    # memory word address
        self.mold_b = take(4)  # old memory word
        self.mem1_b = take(4)  # store-value bytes / load sign helpers
        # bitwise chunks
        self.an = take(nbw)
        self.bn = take(nbw)
        self.zn = take(nbw)
        self.bneg = take()    # sign bit of bitwise immediate
        # memory
        self.bo = take(4)     # byte-offset one-hot
        self.mold = take()
        self.mval = take()
        self.mlast = take()
        self.mcarry = take()
        self.sbit = take()    # load sign bit (LB/LH)
        # boundary records
        self.isel = take()
        self.iaddr = take()
        self.ival = take()
        self.fsel = take()
        self.faddr = take()
        self.fval = take()
        self.ftime = take()
        self.ncols = i


LAYOUT = Layout()


def _signed(v: int) -> int:
    return v - TWO32 if v >= TWO32 // 2 else v


def execute(program: list[Instr], max_steps: int, regs0=None, memory=None):
    """Concrete RV32IM execution. Memory is byte-addressed; the RAM
    argument keys records by word address, so `memory` maps word-aligned
    addresses to 32-bit words."""
    regs = list(regs0 or [0] * 32)
    regs[0] = 0
    mem = dict(memory or {})          # word address -> word
    init_mem = dict(memory or {})
    last_access: dict[int, int] = {}
    pc = 0
    rows = []
    for step in range(max_steps):
        word_idx = pc // 4
        if pc % 4 or word_idx >= len(program) or word_idx < 0:
            break
        ins = program[word_idx]
        t = step + 1
        row = {"pc": pc, "regs": list(regs), "instr": ins, "t": t}
        a = regs[ins.rs1]
        b = regs[ins.rs2]
        imm = ins.imm
        res = 0
        flag = 0
        nxt = pc + 4
        wreg = ins.rd if ins.op in WRITING_OPS else None
        if ins.op == "ADD":
            total = a + b
            flag, res = divmod(total, TWO32)
        elif ins.op == "SUB":
            flag = 1 if a < b else 0
            res = (a - b) % TWO32
        elif ins.op == "ADDI":
            total = a + imm
            res = total % TWO32
            flag = (total - res) // TWO32
        elif ins.op == "SLT":
            res = 1 if _signed(a) < _signed(b) else 0
        elif ins.op == "SLTU":
            res = 1 if a < b else 0
        elif ins.op == "SLTI":
            res = 1 if _signed(a) < imm else 0
        elif ins.op == "SLTIU":
            res = 1 if a < imm % TWO32 else 0
        elif ins.op in BITWISE:
            bop = b if ins.op in R_BITWISE else imm % TWO32
            base = ins.op.rstrip("I") if ins.op.endswith("I") else ins.op
            res = {"XOR": a ^ bop, "OR": a | bop, "AND": a & bop}[base]
        elif ins.op in SHIFTS:
            sa = (b if ins.op in VAR_SHIFTS else imm) & 31
            row["sa"] = sa
            base = ins.op[:3]
            if base == "SLL":
                total = a << sa
                flag, res = total >> 32, total % TWO32
            elif base == "SRL":
                res = a >> sa
                flag = a & ((1 << sa) - 1)
            else:  # SRA
                res = (_signed(a) >> sa) % TWO32
                flag = a & ((1 << sa) - 1)
        elif ins.op == "LUI":
            res = (imm << 12) % TWO32
        elif ins.op == "AUIPC":
            res = (pc + (imm << 12)) % TWO32
        elif ins.op == "JAL":
            res = (pc + 4) % TWO32
            nxt = pc + imm
        elif ins.op == "JALR":
            res = (pc + 4) % TWO32
            nxt = (a + imm) % TWO32 & ~1
        elif ins.op in BRANCHES:
            if ins.op in ("BEQ", "BNE"):
                flag = 1 if a == b else 0
                taken = flag if ins.op == "BEQ" else 1 - flag
            elif ins.op == "BLT":
                flag = 1 if _signed(a) < _signed(b) else 0
                taken = flag
            elif ins.op == "BGE":
                flag = 1 if _signed(a) < _signed(b) else 0
                taken = 1 - flag
            elif ins.op == "BLTU":
                flag = 1 if a < b else 0
                taken = flag
            else:  # BGEU
                flag = 1 if a < b else 0
                taken = 1 - flag
            nxt = pc + (imm if taken else 4)
        elif ins.op in MEM_OPS:
            addr = (a + imm) % TWO32
            boff = addr & 3
            wa = addr >> 2
            old = mem.get(wa, 0)
            init_mem.setdefault(wa, 0)
            row.update(wa=wa, boff=boff, mold=old,
                       mlast=last_access.get(wa, 0))
            last_access[wa] = t + 1
            if ins.op in LOADS:
                if ins.op == "LW":
                    assert boff == 0, "misaligned LW"
                    res = old
                elif ins.op in ("LH", "LHU"):
                    assert boff in (0, 2), "misaligned LH"
                    h = (old >> (8 * boff)) & 0xFFFF
                    res = h if ins.op == "LHU" else (
                        h | 0xFFFF0000 if h & 0x8000 else h
                    )
                else:  # LB / LBU
                    sb = (old >> (8 * boff)) & 0xFF
                    res = sb if ins.op == "LBU" else (
                        sb | 0xFFFFFF00 if sb & 0x80 else sb
                    )
                row["mval"] = old
            else:
                if ins.op == "SW":
                    assert boff == 0, "misaligned SW"
                    new = b
                elif ins.op == "SH":
                    assert boff in (0, 2), "misaligned SH"
                    mask = 0xFFFF << (8 * boff)
                    new = (old & ~mask) | ((b & 0xFFFF) << (8 * boff))
                else:  # SB
                    mask = 0xFF << (8 * boff)
                    new = (old & ~mask) | ((b & 0xFF) << (8 * boff))
                mem[wa] = new
                row["mval"] = new
        elif ins.op == "MUL":
            total = a * b
            flag = 0
            res = total % TWO32
            row["mhi"] = total >> 32
        elif ins.op in MULHS:
            a_s = _signed(a) if ins.op in ("MULH", "MULHSU") else a
            b_s = _signed(b) if ins.op == "MULH" else b
            sprod = a_s * b_s
            flag = 1 if sprod < 0 else 0
            total = sprod % (1 << 64)
            res = total >> 32
            row["mlo"] = total % TWO32
        elif ins.op in DIVS:
            if ins.op in ("DIVU", "REMU"):
                if b == 0:
                    q, r = TWO32 - 1, a
                    qq = rr = 0
                else:
                    qq, rr = divmod(a, b)
                    q, r = qq, rr
                res = q if ins.op == "DIVU" else r
            else:
                a_s, b_s = _signed(a), _signed(b)
                if b == 0:
                    q, r = -1, a_s
                    qq = rr = 0
                else:
                    qq, rr = divmod(abs(a_s), abs(b_s))
                    q = -qq if (a_s < 0) != (b_s < 0) else qq
                    r = -rr if a_s < 0 else rr
                res = (q if ins.op == "DIV" else r) % TWO32
            row["qq"], row["rr"] = qq, rr
        elif ins.op in NOOPS:
            pass
        else:
            raise ValueError(f"unsupported op {ins.op}")
        row["res"] = res
        row["flag"] = flag
        rows.append(row)
        if wreg is not None and wreg != 0:
            regs[wreg] = res
        pc = nxt
    state = {
        "regs": regs, "pc": pc, "memory": mem, "init_memory": init_mem,
        "last_access": last_access,
    }
    return rows, state


# ---------------------------------------------------------------------------
# witness columns
# ---------------------------------------------------------------------------


def _bytes4(v: int) -> list[int]:
    return [(v >> (8 * k)) & 0xFF for k in range(4)]


def rom_table(f: FieldParams, program: list[Instr]) -> FixedTable:
    """(pc, descriptor, imm): descriptor packs (op_id, rd, rs1, rs2)."""
    pcs, descs, imms = [], [], []
    for w, ins in enumerate(program):
        pcs.append(4 * w)
        descs.append(
            OP_ID[ins.op] + (ins.rd << 6) + (ins.rs1 << 11) + (ins.rs2 << 16)
        )
        imms.append(ins.imm % f.p)
    return FixedTable(TBL_ROM, "rom", [pcs, descs, imms])


def pow2_table() -> FixedTable:
    sas = list(range(32))
    return FixedTable(
        TBL_POW2, "pow2", [sas, [1 << s for s in sas], [1 << (32 - s) for s in sas]]
    )


def byte_table() -> FixedTable:
    return FixedTable(TBL_BYTE, "byte", [list(range(256))])


def build_columns(f: FieldParams, rows, state, n: int, L: Layout | None = None):
    L = L or LAYOUT
    p = f.p
    init_mem = state["init_memory"]
    nboundary = len(init_mem)
    assert len(rows) + 1 + nboundary <= n, "trace + boundary rows exceed domain"
    cols = [[0] * n for _ in range(L.ncols)]
    for i, row in enumerate(rows):
        ins: Instr = row["instr"]
        a = row["regs"][ins.rs1]
        b = row["regs"][ins.rs2]
        res = row["res"]
        flag = row["flag"]
        cols[L.pc][i] = row["pc"]
        for r in range(32):
            cols[L.regs[r]][i] = row["regs"][r]
        cols[L.sel[ins.op]][i] = 1
        cols[L.rd_oh[ins.rd]][i] = 1
        cols[L.rs1_oh[ins.rs1]][i] = 1
        cols[L.rs2_oh[ins.rs2]][i] = 1
        cols[L.imm][i] = ins.imm % p
        cols[L.res][i] = res
        cols[L.flag][i] = flag % p
        cols[L.idx][i] = row["t"]
        for k, bv in enumerate(_bytes4(res)):
            cols[L.res_b[k]][i] = bv

        auxa = auxb = auxc = auxd = 0
        if ins.op in ("BEQ", "BNE"):
            diff = (a - b) % p
            cols[L.inv][i] = pow(diff, -1, p) if diff else 0
        if ins.op in MSB_A_OPS:
            cols[L.msb_a][i] = a >> 31
            auxb = 2 * (a - (a >> 31) * (1 << 31))
        if ins.op in MSB_B_OPS:
            cols[L.msb_b][i] = b >> 31
            auxc = 2 * (b - (b >> 31) * (1 << 31))
        if ins.op in ("SLT", "SLTU", "SLTI", "SLTIU") or ins.op in BRANCHES:
            if ins.op in ("SLT", "BLT", "BGE"):
                c = flag if ins.op in BRANCHES else res
                d = a - b + (1 << 31) * (2 * (b >> 31) - 2 * (a >> 31)) + c * TWO32
                if ins.op in ("BLT", "BGE"):
                    cols[L.msb_a][i] = a >> 31
                    auxb = 2 * (a - (a >> 31) * (1 << 31))
                    cols[L.msb_b][i] = b >> 31
                    auxc = 2 * (b - (b >> 31) * (1 << 31))
            elif ins.op in ("SLTU", "BLTU", "BGEU"):
                c = flag if ins.op in BRANCHES else res
                d = a - b + c * TWO32
            elif ins.op in ("SLTI", "SLTIU"):
                imm32 = ins.imm % TWO32
                cols[L.imm32][i] = imm32
                cols[L.ineg][i] = 1 if ins.imm < 0 else 0
                auxd = imm32
                if ins.op == "SLTI":
                    d = (
                        a - imm32
                        + (1 << 31) * (2 * (imm32 >> 31) - 2 * (a >> 31))
                        + res * TWO32
                    )
                else:
                    d = a - imm32 + res * TWO32
            else:  # BEQ/BNE use the inverse trick, no d
                d = 0
            if d:
                assert 0 <= d < TWO32, (ins.op, d)
            auxa = d
        if ins.op in SHIFTS:
            sa = row["sa"]
            cols[L.sa][i] = sa
            cols[L.pw][i] = 1 << sa
            cols[L.pw2b][i] = 1 << (32 - sa)
            auxa = flag
            auxb = flag * (1 << (32 - sa))
            if ins.op in VAR_SHIFTS:
                cols[L.shq][i] = (b - sa) // 32
                auxd = (b - sa) // 32
            if ins.op in ("SRA", "SRAI"):
                # msb_a tie shares auxb with the shift bound -> SRA uses
                # auxc for its msb tie instead (disjoint from msb_b ops)
                cols[L.msb_a][i] = a >> 31
                auxc = 2 * (a - (a >> 31) * (1 << 31))
                auxb = flag * (1 << (32 - sa))
        if ins.op == "MUL":
            auxa = row["mhi"]
        if ins.op in MULHS:
            auxa = row["mlo"]
        if ins.op in DIVS:
            cols[L.qq][i] = row["qq"]
            cols[L.rr][i] = row["rr"]
            bz = 1 if b == 0 else 0
            cols[L.bz][i] = bz
            cols[L.ibz][i] = pow(b, -1, p) if b else 0
            cols[L.nzq][i] = 1 if row["qq"] else 0
            cols[L.iqq][i] = pow(row["qq"], -1, p) if row["qq"] else 0
            cols[L.nzr][i] = 1 if row["rr"] else 0
            cols[L.irr][i] = pow(row["rr"], -1, p) if row["rr"] else 0
            auxa = row["qq"]
            if not bz:
                bb = abs(_signed(b)) if ins.op in ("DIV", "REM") else b
                auxd = bb - row["rr"] - 1
        if ins.op == "JALR":
            target = (a + ins.imm) % TWO32
            cols[L.jt][i] = target & ~1
            cols[L.jt2][i] = ((target & ~1) & 0xFF) >> 1
            cols[L.jlsb][i] = target & 1
            total = a + ins.imm
            cols[L.jcarry][i] = (total - target) // TWO32 % p
            auxa = target & ~1
        if ins.op == "AUIPC":
            total = row["pc"] + ((ins.imm << 12) % TWO32)
            cols[L.acar][i] = total // TWO32
        if ins.op in MEM_OPS:
            wa, boff = row["wa"], row["boff"]
            cols[L.bo[boff]][i] = 1
            cols[L.mold][i] = row["mold"]
            cols[L.mval][i] = row["mval"]
            cols[L.mlast][i] = row["mlast"]
            total = a + ins.imm
            addr = total % TWO32
            cols[L.mcarry][i] = (total - addr) // TWO32 % p
            for k, bv in enumerate(_bytes4(wa)):
                cols[L.wa_b[k]][i] = bv
            for k, bv in enumerate(_bytes4(row["mold"])):
                cols[L.mold_b[k]][i] = bv
            auxb = row["t"] - row["mlast"]
            assert auxb >= 0
            if ins.op in STORES:
                for k, bv in enumerate(_bytes4(b)):
                    cols[L.mem1_b[k]][i] = bv
            elif ins.op in ("LB", "LBU"):
                sb = (row["mold"] >> (8 * boff)) & 0xFF
                sbit = (sb >> 7) & 1 if ins.op == "LB" else 0
                cols[L.sbit][i] = sbit
                cols[L.mem1_b[0]][i] = 2 * (sb - 128 * sbit) if ins.op == "LB" else 0
            elif ins.op == "LH":
                h = (row["mold"] >> (8 * boff)) & 0xFFFF
                sbit = (h >> 15) & 1
                cols[L.sbit][i] = sbit
                low15 = h - (1 << 15) * sbit
                cols[L.mem1_b[0]][i] = low15 & 0xFF
                cols[L.mem1_b[1]][i] = low15 >> 8
                cols[L.mem1_b[2]][i] = 2 * (low15 >> 8)
        for k, bv in enumerate(_bytes4(auxa)):
            cols[L.auxa_b[k]][i] = bv
        for k, bv in enumerate(_bytes4(auxb)):
            cols[L.auxb_b[k]][i] = bv
        for k, bv in enumerate(_bytes4(auxc)):
            cols[L.auxc_b[k]][i] = bv
        for k, bv in enumerate(_bytes4(auxd)):
            cols[L.auxd_b[k]][i] = bv
        if ins.op in BITWISE:
            bop = b if ins.op in R_BITWISE else ins.imm % TWO32
            if ins.op in I_BITWISE:
                cols[L.bneg][i] = 1 if ins.imm < 0 else 0
            bw = L.bw_bits
            mask = (1 << bw) - 1
            for k in range(len(L.an)):
                cols[L.an[k]][i] = (a >> (bw * k)) & mask
                cols[L.bn[k]][i] = (bop >> (bw * k)) & mask
                cols[L.zn[k]][i] = (res >> (bw * k)) & mask

    fin = len(rows)
    for r in range(32):
        cols[L.regs[r]][fin] = state["regs"][r]
    cols[L.pc][fin] = state["pc"]
    cols[L.idx][fin] = len(rows) + 1

    for k, addr in enumerate(sorted(init_mem)):
        i = fin + 1 + k
        cols[L.isel][i] = 1
        cols[L.iaddr][i] = addr
        cols[L.ival][i] = init_mem[addr]
        cols[L.fsel][i] = 1
        cols[L.faddr][i] = addr
        cols[L.fval][i] = state["memory"].get(addr, 0)
        cols[L.ftime][i] = state["last_access"].get(addr, 0)
    return cols


# ---------------------------------------------------------------------------
# constraints + lookup specs
# ---------------------------------------------------------------------------


def _c(i, row=E.CURR):
    from .pickles import col

    return E.Cell(col(i), row)


def make_logup(f: FieldParams, program: list[Instr], n: int, L: Layout | None = None) -> MultiLogup:
    L = L or LAYOUT
    one = E.Literal(1)
    sel = {op: _c(L.sel[op]) for op in OPS}

    def sel_sum(ops):
        s: E.Expr = E.Literal(0)
        for op in ops:
            s = s + sel[op]
        return s

    sel_any = sel_sum(OPS)
    specs: list[LookupSpec] = []

    rd_e: E.Expr = E.Literal(0)
    rs1_e: E.Expr = E.Literal(0)
    rs2_e: E.Expr = E.Literal(0)
    for r in range(32):
        rd_e = rd_e + E.Literal(r) * _c(L.rd_oh[r])
        rs1_e = rs1_e + E.Literal(r) * _c(L.rs1_oh[r])
        rs2_e = rs2_e + E.Literal(r) * _c(L.rs2_oh[r])
    opid_e: E.Expr = E.Literal(0)
    for op in OPS:
        opid_e = opid_e + E.Literal(OP_ID[op]) * sel[op]
    desc = (
        opid_e
        + E.Literal(1 << 6) * rd_e
        + E.Literal(1 << 11) * rs1_e
        + E.Literal(1 << 16) * rs2_e
    )
    specs.append(LookupSpec(TBL_ROM, sel_any, [_c(L.pc), desc, _c(L.imm)]))

    for group in (L.res_b, L.auxa_b, L.auxb_b, L.auxc_b, L.auxd_b,
                  L.wa_b, L.mold_b, L.mem1_b):
        for ci in group:
            specs.append(LookupSpec(TBL_BYTE, one, [_c(ci)]))
    # wa < 2^30 (word-address aliasing guard: 4*wa must not wrap) and
    # jt2 < 128 (JALR evenness); both are 0 on unrelated rows
    specs.append(LookupSpec(TBL_BYTE, one, [E.Literal(4) * _c(L.wa_b[3])]))
    specs.append(LookupSpec(TBL_BYTE, one, [E.Literal(2) * _c(L.jt2)]))

    sel_bw = sel_sum(BITWISE)
    opid_bw: E.Expr = E.Literal(0)
    for op in BITWISE:
        if _BITWISE_OPID[op]:
            opid_bw = opid_bw + E.Literal(_BITWISE_OPID[op]) * sel[op]
    for k in range(len(L.an)):
        specs.append(
            LookupSpec(
                TBL_BITWISE, sel_bw, [opid_bw, _c(L.an[k]), _c(L.bn[k]), _c(L.zn[k])]
            )
        )

    specs.append(
        LookupSpec(TBL_POW2, sel_sum(SHIFTS), [_c(L.sa), _c(L.pw), _c(L.pw2b)])
    )

    wa_e: E.Expr = E.Literal(0)
    for k, ci in enumerate(L.wa_b):
        wa_e = wa_e + E.Literal(1 << (8 * k)) * _c(ci)
    sel_mem = sel_sum(MEM_OPS)
    specs.append(
        LookupSpec(TBL_MEMORY, sel_mem, [wa_e, _c(L.mlast), _c(L.mold)])
    )
    specs.append(
        LookupSpec(
            TBL_MEMORY,
            E.Literal(0) - sel_mem,
            [wa_e, _c(L.idx) + one, _c(L.mval)],
        )
    )
    specs.append(
        LookupSpec(
            TBL_MEMORY, E.Literal(0) - _c(L.isel),
            [_c(L.iaddr), E.Literal(0), _c(L.ival)],
        )
    )
    specs.append(
        LookupSpec(TBL_MEMORY, _c(L.fsel), [_c(L.faddr), _c(L.ftime), _c(L.fval)])
    )

    tables = [byte_table(), bitwise_table(TBL_BITWISE, L.bw_bits), pow2_table(),
              rom_table(f, program)]
    return MultiLogup(f, specs, tables, n, L.ncols)


def constraints(
    f: FieldParams,
    logup: MultiLogup,
    k_steps: int,
    regs0: list[int] | None = None,
    final_state: dict | None = None,
    omega: int | None = None,
    L: Layout | None = None,
) -> list[E.Expr]:
    L = L or LAYOUT
    n = logup.n
    p = f.p
    one = E.Literal(1)
    sel = {op: _c(L.sel[op]) for op in OPS}

    def sel_sum(ops):
        s: E.Expr = E.Literal(0)
        for op in ops:
            s = s + sel[op]
        return s

    sel_any = sel_sum(OPS)

    rs1v: E.Expr = E.Literal(0)
    rs2v: E.Expr = E.Literal(0)
    for r in range(32):
        rs1v = rs1v + _c(L.rs1_oh[r]) * _c(L.regs[r])
        rs2v = rs2v + _c(L.rs2_oh[r]) * _c(L.regs[r])

    imm = _c(L.imm)
    res = _c(L.res)
    flag = _c(L.flag)
    inv = _c(L.inv)
    idx = _c(L.idx)
    pc = _c(L.pc)
    pc_n = _c(L.pc, E.NEXT)
    two32 = E.Literal(TWO32 % p)
    two31 = E.Literal(1 << 31)
    four = E.Literal(4)

    def bytes_sum(group):
        s: E.Expr = E.Literal(0)
        for k, ci in enumerate(group):
            s = s + E.Literal(1 << (8 * k)) * _c(ci)
        return s

    def nib_sum(group):
        s: E.Expr = E.Literal(0)
        for k, ci in enumerate(group):
            s = s + E.Literal(1 << (L.bw_bits * k)) * _c(ci)
        return s

    out: list[E.Expr] = []
    for op in OPS:
        out.append(sel[op].boolean())
    out.append(sel_any * (sel_any - one))
    sel_any_next: E.Expr = E.Literal(0)
    for op in OPS:
        sel_any_next = sel_any_next + _c(L.sel[op], E.NEXT)
    assert omega is not None
    ell_last = E.UnnormalizedLagrangeBasis(n - 1) * E.Literal(
        pow(omega, n - 1, p) * pow(n, -1, p) % p
    )
    out.append((one - ell_last) * sel_any_next * (one - sel_any))
    for group in (L.rd_oh, L.rs1_oh, L.rs2_oh):
        total: E.Expr = E.Literal(0)
        for i in group:
            out.append(_c(i).boolean())
            total = total + _c(i)
        out.append(total - sel_any)
    out.append(_c(L.regs[0]))
    out.append(sel_any * (_c(L.idx, E.NEXT) - idx - one))
    out.append(res - bytes_sum(L.res_b))

    bitflag = sel_sum(["ADD", "SUB", "BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU",
                       "MULH", "MULHSU", "MULHU"])
    out.append(bitflag * flag.boolean())
    out.append(sel["ADDI"] * flag * (flag - one) * (flag + one))

    writes = sel_sum(WRITING_OPS)
    for r in range(32):
        reg = _c(L.regs[r])
        reg_n = _c(L.regs[r], E.NEXT)
        wr = _c(L.rd_oh[r]) * writes if r != 0 else E.Literal(0)
        out.append(sel_any * (wr * (reg_n - res) + (one - wr) * (reg_n - reg)))

    msb_a, msb_b = _c(L.msb_a), _c(L.msb_b)
    out.append(msb_a * (msb_a - one))
    out.append(msb_b * (msb_b - one))
    msb_a_tie = sel_sum([op for op in MSB_A_OPS if op not in ("SRA", "SRAI")])
    out.append(
        msb_a_tie * (bytes_sum(L.auxb_b) - E.Literal(2) * (rs1v - msb_a * two31))
    )
    # SRA msb tie rides auxc (its auxb holds the shift bound)
    out.append(
        sel_sum(["SRA", "SRAI"])
        * (bytes_sum(L.auxc_b) - E.Literal(2) * (rs1v - msb_a * two31))
    )
    out.append(
        sel_sum(MSB_B_OPS) * (bytes_sum(L.auxc_b) - E.Literal(2) * (rs2v - msb_b * two31))
    )

    # ALU
    out.append(sel["ADD"] * (rs1v + rs2v - flag * two32 - res))
    out.append(sel["SUB"] * (rs1v - rs2v + flag * two32 - res))
    out.append(sel["ADDI"] * (rs1v + imm - flag * two32 - res))
    out.append(sel["LUI"] * (imm * E.Literal(1 << 12) - res))
    acar = _c(L.acar)
    out.append(acar * (acar - one))
    out.append(sel["AUIPC"] * (pc + imm * E.Literal(1 << 12) - acar * two32 - res))

    # comparisons (res) and compare-branches (flag) share the d bound
    cmps = sel_sum(["SLT", "SLTU", "SLTI", "SLTIU"])
    out.append(cmps * res.boolean())
    d = bytes_sum(L.auxa_b)
    out.append(sel["SLTU"] * (d - (rs1v - rs2v + res * two32)))
    out.append(
        sel["SLT"]
        * (d - (rs1v - rs2v + E.Literal(2) * two31 * (msb_b - msb_a) + res * two32))
    )
    imm32 = _c(L.imm32)
    ineg = _c(L.ineg)
    out.append(ineg * (ineg - one))
    slti_ops = sel_sum(["SLTI", "SLTIU"])
    out.append(slti_ops * (imm32 - imm - ineg * two32))
    out.append(slti_ops * (bytes_sum(L.auxd_b) - imm32))
    out.append(sel["SLTIU"] * (d - (rs1v - imm32 + res * two32)))
    out.append(
        sel["SLTI"]
        * (d - (rs1v - imm32 + E.Literal(2) * two31 * (ineg - msb_a) + res * two32))
    )
    out.append(
        sel_sum(["BLTU", "BGEU"]) * (d - (rs1v - rs2v + flag * two32))
    )
    out.append(
        sel_sum(["BLT", "BGE"])
        * (d - (rs1v - rs2v + E.Literal(2) * two31 * (msb_b - msb_a) + flag * two32))
    )

    # shifts
    pw, pw2b, sa_c, shq = _c(L.pw), _c(L.pw2b), _c(L.sa), _c(L.shq)
    sh_all = sel_sum(SHIFTS)
    out.append(sh_all * (bytes_sum(L.auxa_b) - flag))
    out.append(sh_all * (bytes_sum(L.auxb_b) - flag * pw2b))
    out.append(sel_sum(CONST_SHIFTS) * (sa_c - imm))
    var_sh = sel_sum(VAR_SHIFTS)
    out.append(var_sh * (rs2v - E.Literal(32) * shq - sa_c))
    out.append(var_sh * (bytes_sum(L.auxd_b) - shq))
    out.append(sel_sum(["SLL", "SLLI"]) * (rs1v * pw - flag * two32 - res))
    out.append(sel_sum(["SRL", "SRLI"]) * (res * pw + flag - rs1v))
    out.append(
        sel_sum(["SRA", "SRAI"])
        * ((res - msb_a * two32) * pw + flag - (rs1v - msb_a * two32))
    )

    # bitwise (immediate variant sign-extends, bneg resolves the branch)
    sel_rbw = sel_sum(R_BITWISE)
    sel_ibw = sel_sum(I_BITWISE)
    sel_bw = sel_rbw + sel_ibw
    bneg = _c(L.bneg)
    out.append(bneg * (bneg - one))
    out.append(sel_bw * (nib_sum(L.an) - rs1v))
    out.append(
        sel_rbw * (nib_sum(L.bn) - rs2v)
        + sel_ibw * (nib_sum(L.bn) - imm - bneg * two32)
    )
    out.append(sel_bw * (nib_sum(L.zn) - res))

    # M extension
    mhi = bytes_sum(L.auxa_b)
    out.append(sel["MUL"] * (rs1v * rs2v - mhi * two32 - res))
    mlo = bytes_sum(L.auxa_b)
    a_s = rs1v - msb_a * two32
    b_s = rs2v - msb_b * two32
    out.append(sel["MULH"] * (a_s * b_s - (res - flag * two32) * two32 - mlo))
    out.append(sel["MULHSU"] * (a_s * rs2v - (res - flag * two32) * two32 - mlo))
    out.append(sel["MULHU"] * (rs1v * rs2v - res * two32 - mlo))

    qq, rr = _c(L.qq), _c(L.rr)
    bz, ibz = _c(L.bz), _c(L.ibz)
    nzq, iqq = _c(L.nzq), _c(L.iqq)
    nzr, irr = _c(L.nzr), _c(L.irr)
    divs = sel_sum(DIVS)
    out.append(divs * bz * (bz - one))
    out.append(divs * bz * rs2v)
    out.append(divs * (rs2v * ibz - (one - bz)))
    out.append(divs * (bytes_sum(L.auxa_b) - qq))
    out.append(divs * (qq * iqq - nzq))
    out.append(divs * nzq * (nzq - one))
    out.append(divs * (one - nzq) * qq)
    out.append(divs * (rr * irr - nzr))
    out.append(divs * nzr * (nzr - one))
    out.append(divs * (one - nzr) * rr)
    udiv = sel_sum(["DIVU", "REMU"])
    out.append(udiv * (one - bz) * (rs1v - qq * rs2v - rr))
    out.append(udiv * (bytes_sum(L.auxd_b) - (one - bz) * (rs2v - rr - one)))
    aa = (one - E.Literal(2) * msb_a) * a_s
    bb = (one - E.Literal(2) * msb_b) * b_s
    sdiv = sel_sum(["DIV", "REM"])
    out.append(sdiv * (one - bz) * (aa - qq * bb - rr))
    out.append(sdiv * (bytes_sum(L.auxd_b) - (one - bz) * (bb - rr - one)))
    sgn = msb_a + msb_b - E.Literal(2) * msb_a * msb_b  # quotient sign
    out.append(
        sel["DIVU"] * (res - bz * E.Literal(TWO32 - 1) - (one - bz) * qq)
    )
    out.append(sel["REMU"] * (res - bz * rs1v - (one - bz) * rr))
    out.append(
        sel["DIV"]
        * (
            res
            - bz * E.Literal(TWO32 - 1)
            - (one - bz) * (qq + sgn * nzq * (two32 - E.Literal(2) * qq))
        )
    )
    out.append(
        sel["REM"]
        * (
            res
            - bz * rs1v
            - (one - bz) * (rr + msb_a * nzr * (two32 - E.Literal(2) * rr))
        )
    )

    # memory
    wa = bytes_sum(L.wa_b)
    bo = [_c(ci) for ci in L.bo]
    boff: E.Expr = E.Literal(0)
    for k in range(4):
        out.append(bo[k] * (bo[k] - one))
        boff = boff + E.Literal(k) * bo[k]
    sel_mem = sel_sum(MEM_OPS)
    bo_total = bo[0] + bo[1] + bo[2] + bo[3]
    out.append(bo_total - sel_mem)
    mold, mval = _c(L.mold), _c(L.mval)
    mlast, mcarry = _c(L.mlast), _c(L.mcarry)
    out.append(sel_mem * mcarry * (mcarry - one) * (mcarry + one))
    out.append(sel_mem * (four * wa + boff - rs1v - imm + mcarry * two32))
    out.append(sel_mem * (bytes_sum(L.auxb_b) - (idx - mlast)))
    out.append(sel_mem * (bytes_sum(L.mold_b) - mold))
    # alignment
    out.append(sel_sum(["LW", "SW"]) * (one - bo[0]))
    out.append(sel_sum(["LH", "LHU", "SH"]) * (bo[1] + bo[3]))
    # loads
    sbit = _c(L.sbit)
    out.append(sbit * (sbit - one))
    out.append(sel["LW"] * (res - mold))
    mb = [_c(ci) for ci in L.mold_b]
    sb_sel = (
        bo[0] * mb[0] + bo[1] * mb[1] + bo[2] * mb[2] + bo[3] * mb[3]
    )
    m1 = [_c(ci) for ci in L.mem1_b]
    out.append(
        sel["LB"] * (m1[0] - E.Literal(2) * (sb_sel - E.Literal(128) * sbit))
    )
    out.append(sel["LB"] * (res - sb_sel - sbit * E.Literal(TWO32 - 256)))
    out.append(sel["LBU"] * (res - sb_sel))
    half = (
        bo[0] * (mb[0] + E.Literal(256) * mb[1])
        + bo[2] * (mb[2] + E.Literal(256) * mb[3])
    )
    out.append(
        sel["LH"]
        * (m1[0] + E.Literal(256) * m1[1] - (half - E.Literal(1 << 15) * sbit))
    )
    out.append(sel["LH"] * (m1[2] - E.Literal(2) * m1[1]))
    out.append(sel["LH"] * (res - half - sbit * E.Literal(TWO32 - (1 << 16))))
    out.append(sel["LHU"] * (res - half))
    out.append(sel_sum(LOADS) * (mval - mold))
    # stores: mem1_b decomposes rs2v; mval inserts the sub-word
    sel_store = sel_sum(STORES)
    out.append(sel_store * (bytes_sum(L.mem1_b) - rs2v))
    out.append(sel["SW"] * (mval - rs2v))
    ins_b: E.Expr = E.Literal(0)
    for k in range(4):
        ins_b = ins_b + bo[k] * E.Literal(1 << (8 * k)) * (m1[0] - mb[k])
    out.append(sel["SB"] * (mval - mold - ins_b))
    sv_half = m1[0] + E.Literal(256) * m1[1]
    ins_h = (
        bo[0] * (sv_half - (mb[0] + E.Literal(256) * mb[1]))
        + bo[2] * E.Literal(1 << 16) * (sv_half - (mb[2] + E.Literal(256) * mb[3]))
    )
    out.append(sel["SH"] * (mval - mold - ins_h))

    # branch equality
    diff = rs1v - rs2v
    br_eq = sel_sum(["BEQ", "BNE"])
    out.append(br_eq * (diff * flag))
    out.append(br_eq * (diff * inv - (one - flag)))

    # JALR target: jt < 2^32 (auxa bytes); evenness via jt's low byte
    # being 2*jt2 with jt2 < 128 (the byte lookup on 2*jt2 bounds it —
    # a plain jt = 2*h constraint would be vacuous field division)
    jt, jt2, jlsb, jcarry = _c(L.jt), _c(L.jt2), _c(L.jlsb), _c(L.jcarry)
    out.append(jlsb * (jlsb - one))
    out.append(sel["JALR"] * jcarry * (jcarry - one) * (jcarry + one))
    out.append(sel["JALR"] * (rs1v + imm - jcarry * two32 - jt - jlsb))
    out.append(sel["JALR"] * (_c(L.auxa_b[0]) - E.Literal(2) * jt2))
    out.append(sel["JALR"] * (bytes_sum(L.auxa_b) - jt))
    out.append(sel_sum(["JAL", "JALR"]) * (res - pc - four))

    # program counter
    seq = sel_sum([op for op in OPS if op not in ("JAL", "JALR") + tuple(BRANCHES)])
    out.append(seq * (pc_n - pc - four))
    out.append(sel["JAL"] * (pc_n - pc - imm))
    out.append(sel["JALR"] * (pc_n - jt))
    taken = {
        "BEQ": flag, "BNE": one - flag, "BLT": flag, "BGE": one - flag,
        "BLTU": flag, "BGEU": one - flag,
    }
    for op in BRANCHES:
        out.append(sel[op] * (pc_n - pc - four - taken[op] * (imm - four)))

    # boundary record selectors only on padding rows
    out.append(_c(L.isel) * (_c(L.isel) - one))
    out.append(_c(L.fsel) * (_c(L.fsel) - one))
    out.append(sel_any * _c(L.isel))
    out.append(sel_any * _c(L.fsel))

    L0 = E.UnnormalizedLagrangeBasis(0)
    out.append(L0 * pc)
    out.append(L0 * (idx - one))
    regs0 = regs0 or [0] * 32
    for r in range(32):
        out.append(L0 * (_c(L.regs[r]) - E.Literal(regs0[r] % p)))
    if final_state is not None:
        Lk = E.UnnormalizedLagrangeBasis(k_steps)
        out.append(Lk * (pc - E.Literal(final_state["pc"] % p)))
        for r in range(32):
            out.append(Lk * (_c(L.regs[r]) - E.Literal(final_state["regs"][r] % p)))

    out.extend(logup.constraints())
    return out


# ---------------------------------------------------------------------------
# prove / verify
# ---------------------------------------------------------------------------


def _boundary_pin_columns(f, init_mem, final_mem, last_access, k_steps, n,
                          L: Layout | None = None):
    L = L or LAYOUT
    cols = {
        L.isel: [0] * n, L.iaddr: [0] * n, L.ival: [0] * n,
        L.fsel: [0] * n, L.faddr: [0] * n, L.fval: [0] * n, L.ftime: [0] * n,
    }
    for k, addr in enumerate(sorted(init_mem)):
        i = k_steps + 1 + k
        cols[L.isel][i] = 1
        cols[L.iaddr][i] = addr
        cols[L.ival][i] = init_mem[addr]
        cols[L.fsel][i] = 1
        cols[L.faddr][i] = addr
        cols[L.fval][i] = final_mem.get(addr, 0)
        cols[L.ftime][i] = last_access.get(addr, 0)
    return cols


def statement_to_json(statement: dict) -> dict:
    """A statement of prove_execution as JSON data: instructions as
    [op, rd, rs1, rs2, imm], memory maps as sorted [address, value] pairs."""
    fin = statement["final"]

    def pairs(m: dict) -> list:
        return [[k, v] for k, v in sorted(m.items())]

    return {
        "program": [[i.op, i.rd, i.rs1, i.rs2, i.imm] for i in statement["program"]],
        "k_steps": statement["k_steps"],
        "regs0": list(statement["regs0"]),
        "init_memory": pairs(statement["init_memory"]),
        "bitwise_bits": statement["bitwise_bits"],
        "final": {"regs": list(fin["regs"]), "pc": fin["pc"], "memory": pairs(fin["memory"]),
                  "last_access": pairs(fin["last_access"])},
    }


def statement_from_json(data: dict) -> dict:
    """statement_to_json's data -> the statement verify_execution takes."""
    fin = data["final"]
    return {
        "program": [Instr(*row) for row in data["program"]],
        "k_steps": data["k_steps"],
        "regs0": list(data["regs0"]),
        "init_memory": {a: v for a, v in data["init_memory"]},
        "bitwise_bits": data["bitwise_bits"],
        "final": {"regs": list(fin["regs"]), "pc": fin["pc"],
                  "memory": {a: v for a, v in fin["memory"]},
                  "last_access": {a: t for a, t in fin["last_access"]}},
    }


def prove_execution(domain, srs, curve, program: list[Instr], n: int, rng,
                    regs0=None, memory=None, max_steps=None,
                    L: Layout | None = None, device=None):
    """Execute + prove, on `device` (the card unless the caller passes
    device="cpu"), where `domain` and `srs` live too. Returns
    (proof, statement): the program, k_steps, regs0, the initial memory,
    the bitwise chunk width and the final registers, pc, memory and last
    access times."""
    from ..ops import limb
    from .pickles import prove_columns

    dev = resolve_device(device)
    L = L or LAYOUT
    f = curve.scalar
    rows, state = execute(program, max_steps or (n // 2), regs0, memory)
    cols = build_columns(f, rows, state, n, L)
    logup = make_logup(f, program, n, L)
    full = logup.phase1_columns(cols)
    cons = constraints(
        f, logup, len(rows), regs0, state, domain.d1.group_gen, L
    )
    F = limb.device_field(f)
    packed = F.pack_mont([v for colv in full for v in colv], shape=(len(full), n), device=dev)
    proof = prove_columns(
        domain, srs, curve, packed, cons, rng,
        make_beta_columns=logup.make_phase2(F, dev), with_joint_combiner=True, device=dev,
    )
    statement = {
        "program": program,
        "k_steps": len(rows),
        "regs0": list(regs0 or [0] * 32),
        "init_memory": dict(state["init_memory"]),
        "bitwise_bits": L.bw_bits,
        "final": {
            "regs": list(state["regs"]), "pc": state["pc"],
            "memory": dict(state["memory"]),
            "last_access": dict(state["last_access"]),
        },
    }
    return proof, statement


def verify_execution(domain, srs, curve, proof, statement, rng, device=None) -> bool:
    """Check an execution proof against its statement: the fixed tables and
    the seven boundary-record columns pinned by recommitment, then the
    column proof. On `device`, the SRS's (the card unless the caller
    passes device="cpu")."""
    from .pickles import pinned_columns_match, verify_columns

    dev = resolve_device(device)
    if torch.device(srs.device).type != dev.type:
        raise ValueError(f"the SRS is on {srs.device}, expected {dev}")
    f = curve.scalar
    n = domain.d1.n
    L = Layout(statement.get("bitwise_bits", 4))
    logup = make_logup(f, statement["program"], n, L)
    cons = constraints(
        f, logup, statement["k_steps"], statement["regs0"], statement["final"],
        domain.d1.group_gen, L,
    )
    if not logup.verify_tables(domain, srs, proof):
        return False
    pin = _boundary_pin_columns(
        f, statement["init_memory"], statement["final"]["memory"],
        statement["final"]["last_access"], statement["k_steps"], n, L,
    )
    if not pinned_columns_match(domain, srs, proof, pin, dev):
        return False
    return verify_columns(
        domain, srs, curve, cons, proof, rng,
        num_beta_columns=logup.num_phase2, with_joint_combiner=True,
    )


# ---------------------------------------------------------------------------
# decoder (riscv32im/interpreter.rs decode capability)
# ---------------------------------------------------------------------------


def decode(word: int) -> Instr:
    opcode = word & 0x7F
    rd = (word >> 7) & 31
    funct3 = (word >> 12) & 7
    rs1 = (word >> 15) & 31
    rs2 = (word >> 20) & 31
    funct7 = (word >> 25) & 0x7F

    def sext(v, bits):
        return v - (1 << bits) if v & (1 << (bits - 1)) else v

    imm_i = sext(word >> 20, 12)
    imm_s = sext(((word >> 25) << 5) | ((word >> 7) & 31), 12)
    imm_b = sext(
        ((word >> 31) << 12)
        | (((word >> 7) & 1) << 11)
        | (((word >> 25) & 0x3F) << 5)
        | (((word >> 8) & 0xF) << 1),
        13,
    )
    imm_j = sext(
        ((word >> 31) << 20)
        | (((word >> 12) & 0xFF) << 12)
        | (((word >> 20) & 1) << 11)
        | (((word >> 21) & 0x3FF) << 1),
        21,
    )
    imm_u = word >> 12

    if opcode == 0x33:  # R-type
        if funct7 == 1:
            m = ["MUL", "MULH", "MULHSU", "MULHU", "DIV", "DIVU", "REM", "REMU"]
            return Instr(m[funct3], rd=rd, rs1=rs1, rs2=rs2)
        table = {
            (0, 0): "ADD", (0x20, 0): "SUB", (0, 1): "SLL", (0, 2): "SLT",
            (0, 3): "SLTU", (0, 4): "XOR", (0, 5): "SRL", (0x20, 5): "SRA",
            (0, 6): "OR", (0, 7): "AND",
        }
        op = table.get((funct7, funct3))
        if op:
            return Instr(op, rd=rd, rs1=rs1, rs2=rs2)
    elif opcode == 0x13:  # I-type ALU
        if funct3 == 1 and funct7 == 0:
            return Instr("SLLI", rd=rd, rs1=rs1, imm=rs2)
        if funct3 == 5:
            return Instr("SRAI" if funct7 == 0x20 else "SRLI", rd=rd, rs1=rs1, imm=rs2)
        table = {0: "ADDI", 2: "SLTI", 3: "SLTIU", 4: "XORI", 6: "ORI", 7: "ANDI"}
        if funct3 in table:
            return Instr(table[funct3], rd=rd, rs1=rs1, imm=imm_i)
    elif opcode == 0x03:  # loads
        table = {0: "LB", 1: "LH", 2: "LW", 4: "LBU", 5: "LHU"}
        if funct3 in table:
            return Instr(table[funct3], rd=rd, rs1=rs1, imm=imm_i)
    elif opcode == 0x23:  # stores
        table = {0: "SB", 1: "SH", 2: "SW"}
        if funct3 in table:
            return Instr(table[funct3], rs1=rs1, rs2=rs2, imm=imm_s)
    elif opcode == 0x37:
        return Instr("LUI", rd=rd, imm=imm_u)
    elif opcode == 0x17:
        return Instr("AUIPC", rd=rd, imm=imm_u)
    elif opcode == 0x63:
        table = {0: "BEQ", 1: "BNE", 4: "BLT", 5: "BGE", 6: "BLTU", 7: "BGEU"}
        if funct3 in table:
            return Instr(table[funct3], rs1=rs1, rs2=rs2, imm=imm_b)
    elif opcode == 0x6F:
        return Instr("JAL", rd=rd, imm=imm_j)
    elif opcode == 0x67 and funct3 == 0:
        return Instr("JALR", rd=rd, rs1=rs1, imm=imm_i)
    elif opcode == 0x0F:
        return Instr("FENCE")
    elif opcode == 0x73 and word in (0x73, 0x100073):
        return Instr("ECALL")
    raise ValueError(f"unsupported instruction word {word:#010x}")
