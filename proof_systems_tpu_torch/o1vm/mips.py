"""MIPS (o1vm/Cannon flavour) execution proofs over the column prover, on
the card.

Counterpart of proof_systems_tpu/o1vm/mips.py. The host code (the
interpreter with the Cannon syscall surface, the decoder, the witness
columns, the lookup specs and the constraint AST) is the JAX package's,
copied as it is (the same dict and list orders); the columns are packed on
the device the caller names (the card unless device="cpu") and prove
through o1vm/pickles.prove_columns with LogUp's phase-2 columns
(o1vm/logup.MultiLogup, host code).

The reference interprets MIPS with a dual-mode interpreter
(o1vm/src/interpreters/mips/interpreter.rs, 2,699 LoC: witness mode
fills columns, constraint mode emits Expr) driven by Cannon state
snapshots, and gets its soundness from RAM lookups: every register and
memory access emits signed LogUp records with access counters
(interpreter.rs:302-486, ramlookup.rs), and every decomposition goes
through fixed range tables (lookups.rs ByteLookup/RangeCheck16).

This module keeps the dual-interpretation architecture and the Cannon
pc/next_pc delay-slot model, with a register-file column
layout (32 register columns propagated row-to-row by selector-gated
consistency constraints — no register RAM argument needed) plus the
full lookup environment via MultiLogup (logup.py):

  - program ROM pinning: every executing row looks up
    (pc, op/reg descriptor, imm) in a fixed per-program ROM table, so
    the proof is bound to THE program (reference: instruction fetch is
    a memory lookup at pc);
  - byte range checks: the written result and three aux values are
    decomposed into bytes looked up in a 256-entry byte table
    (lookups.rs:41 ByteLookup), which bounds every register value to
    32 bits by induction from the pinned initial state;
  - bitwise AND/OR/XOR/NOR(+immediates) via a 1024-entry
    (op, x, y, z) nibble product table;
  - shifts via a 32-entry POW2 table (sa, 2^sa, 2^{32-sa});
  - memory via the offline memory-checking argument: each access emits
    write(addr, last_t, old_v) [+1] and read(addr, t+1, new_v) [-1]
    (interpreter.rs:455-486 access_memory), elapsed time is
    range-checked, and the public initial/final memory enters through
    boundary records on padding rows whose columns the verifier pins
    by recommitting them (prove_execution/verify_execution).

Statement proved: "running program P for k steps from public initial
state (pc=0, regs0, memory0) yields public final state (regs_k, pc_k,
hi/lo_k, memory_k)" — boundary rows are pinned with
UnnormalizedLagrangeBasis constraints at rows 0 and k.

Row layout: see Layout. Witness-mode-only rows no longer exist: every
supported opcode is selector-backed and fully constrained.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circuits import expr as E
from ..fields import FieldParams
from ..runtime import resolve_device
from .logup import (
    BITWISE_NOR,
    BITWISE_OR,
    BITWISE_XOR,
    FixedTable,
    LookupSpec,
    MultiLogup,
    bitwise_table,
)

TWO32 = 1 << 32

# all ops are constraint-backed (selector + semantics + lookups)
OPS = [
    "ADD", "ADDU", "SUB", "SUBU", "ADDI", "ADDIU", "LUI",
    "SLT", "SLTU", "SLTI", "SLTIU",
    "SLL", "SRL", "SRA", "SLLV", "SRLV", "SRAV",
    "MULT", "MULTU", "MFLO", "MFHI",
    "BEQ", "BNE", "J", "JAL", "JR",
    "AND", "OR", "XOR", "NOR", "ANDI", "ORI", "XORI",
    "LW", "SW",
    # Cannon full-ISA extension (o1vm/src/interpreters/mips/interpreter.rs)
    "JALR", "BLTZ", "BGEZ", "BLTZAL", "BGEZAL", "BLEZ", "BGTZ",
    "DIV", "DIVU", "MTHI", "MTLO", "MOVZ", "MOVN", "SYNC",
    "LB", "LBU", "LH", "LHU", "LWL", "LWR",
    "SB", "SH", "SWL", "SWR", "LL", "SC",
    "SYSCALL",
]
OP_ID = {op: i for i, op in enumerate(OPS)}
assert len(OPS) < 64  # ROM descriptor packs op_id in 6 bits

R_BITWISE = ["AND", "OR", "XOR", "NOR"]
I_BITWISE = ["ANDI", "ORI", "XORI"]
BITWISE = R_BITWISE + I_BITWISE
CONST_SHIFTS = ["SLL", "SRL", "SRA"]
VAR_SHIFTS = ["SLLV", "SRLV", "SRAV"]
SHIFTS = CONST_SHIFTS + VAR_SHIFTS
COMPARES = ["SLT", "SLTU", "SLTI", "SLTIU"]
# memory-touching instructions (word ops + sub-word ops); syscall rows
# can also touch memory (preimage read/write) but are gated separately
WORD_MEM = ["LW", "SW", "LL", "SC"]
LOADS = ["LW", "LL", "LB", "LBU", "LH", "LHU", "LWL", "LWR"]
STORES = ["SW", "SC", "SB", "SH", "SWL", "SWR"]
SUBWORD = ["LB", "LBU", "LH", "LHU", "LWL", "LWR", "SB", "SH", "SWL", "SWR"]
MEM_OPS = LOADS + STORES
# ops needing the big-endian byte view of rt (merged stores + merge loads)
RT_BYTE_OPS = ["SB", "SH", "SWL", "SWR", "LWL", "LWR"]
BRANCH_Z = ["BLTZ", "BGEZ", "BLTZAL", "BGEZAL", "BLEZ", "BGTZ"]
BRANCHES = ["BEQ", "BNE"] + BRANCH_Z

# Cannon syscall numbers / fds (cannon.py, interpreter.rs:1148-1463)
SYS_MMAP, SYS_BRK, SYS_CLONE, SYS_EXIT = 4090, 4045, 4120, 4246
SYS_READ, SYS_WRITE, SYS_FCNTL = 4003, 4004, 4055
SYS_NUMS = [SYS_MMAP, SYS_BRK, SYS_CLONE, SYS_EXIT, SYS_READ, SYS_WRITE, SYS_FCNTL]
FD_STDIN, FD_STDOUT, FD_STDERR = 0, 1, 2
FD_HINT_READ, FD_HINT_WRITE = 3, 4
FD_PRE_READ, FD_PRE_WRITE = 5, 6
BRK_BASE = 0x40000000

# syscall row kinds (one-hot); each pins (num, fd/cmd) and fixes v0/v1
SYS_KINDS = [
    "mmap0", "mmap1", "brk", "clone", "exit",
    "rpre", "rhint", "rstdin", "rbad",
    "wpre", "whint", "wout", "wbad",
    "fcr", "fcw", "fceinval", "fcbadf",
    "other",
]

# lookup table ids
TBL_BYTE = 3        # lookups.rs:41 ByteLookup
TBL_BITWISE = 20
TBL_POW2 = 21
TBL_ROM = 22
TBL_MEMORY = 7      # lookups.rs:54 MemoryLookup (RAM, no fixed column)
TBL_PREIMAGE = 23   # (key_hi, key_lo, offset, byte, len) per stream byte
TBL_PRELEN = 24     # (key_hi, key_lo, len) per key

_BITWISE_OPID = {
    "AND": 0, "ANDI": 0, "OR": BITWISE_OR, "ORI": BITWISE_OR,
    "XOR": BITWISE_XOR, "XORI": BITWISE_XOR, "NOR": BITWISE_NOR,
}


@dataclass
class Instr:
    op: str
    rd: int = 0
    rs: int = 0
    rt: int = 0
    imm: int = 0  # shift amount for SLL/SRL/SRA, target for J/JAL


def write_dest(ins: Instr) -> int:
    """Destination register index (normalized: I-type writes rt)."""
    if ins.op in ("JAL", "BLTZAL", "BGEZAL"):
        return 31
    if ins.op in ("ADDI", "ADDIU", "LUI", "SLTI", "SLTIU",
                  "ANDI", "ORI", "XORI") or ins.op in LOADS or ins.op == "SC":
        return ins.rt
    if ins.op in ("BLTZ", "BGEZ", "BLEZ", "BGTZ", "DIV", "DIVU", "MTHI",
                  "MTLO", "SYNC", "SYSCALL") or ins.op in ("SB", "SH", "SWL", "SWR"):
        return 0
    return ins.rd


# unconditional register writers; MOVZ/MOVN write conditionally (zf gate)
# and SYSCALL writes v0/v1 into regs 2/7 via its own constraint terms
WRITING_OPS = [
    op for op in OPS
    if op not in ("MULT", "MULTU", "DIV", "DIVU", "BEQ", "BNE", "BLTZ",
                  "BGEZ", "BLEZ", "BGTZ", "J", "JR", "SW", "SB", "SH",
                  "SWL", "SWR", "MTHI", "MTLO", "SYNC", "SYSCALL",
                  "MOVZ", "MOVN")
]


class Layout:
    """Column layout. `bitwise_bits` sets the bitwise chunk width: 4
    (1024-entry table, production) or 2 (64-entry table, small test
    domains) — the tradeoff is table length vs chunk-column count."""

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
        self.npc = take()
        self.hi = take()
        self.lo = take()
        self.regs = take(32)
        self.sel = {}
        for op in OPS:
            self.sel[op] = take()
        self.rd_oh = take(32)
        self.rs_oh = take(32)
        self.rt_oh = take(32)
        self.imm = take()
        self.res = take()
        self.flag = take()
        self.inv = take()     # branch diff inverse
        self.idx = take()     # time counter: row j has idx = j + 1
        self.pw = take()      # 2^sa for shifts (POW2-pinned)
        self.pw2b = take()    # 2^{32-sa} for shifts (POW2-pinned)
        self.sa = take()      # shift amount (imm or rs&31)
        self.shq = take()     # (rsv - sa)/32 for variable shifts
        self.msb_a = take()   # msb of rsv (signed ops)
        self.msb_b = take()   # msb of rtv (signed ops)
        self.imm32 = take()   # imm mod 2^32 (SLTI/SLTIU)
        self.ineg = take()    # sign bit of the 16-bit immediate
        self.res_b = take(4)  # byte decomposition of res
        self.auxa_b = take(4)
        self.auxb_b = take(4)
        self.auxc_b = take(4)
        self.auxd_b = take(4)
        self.auxe_b = take(4)
        self.auxf_b = take(4)
        self.an = take(nbw)   # bitwise chunks of operand a (rsv)
        self.bn = take(nbw)   # operand b (rtv or imm)
        self.zn = take(nbw)   # result
        self.maddr = take()   # memory address (word-ALIGNED, Cannon model)
        self.mold = take()    # old value at maddr
        self.mval = take()    # new value at maddr
        self.mlast = take()   # last access time of maddr
        self.mcarry = take()  # address wrap carry in {-1,0,1}
        # Cannon full-ISA extension ------------------------------------
        self.zf = take()      # zero flag (rsv for BLEZ/BGTZ; rtv for
        #                       MOVZ/MOVN/DIV/DIVU), tied via inv
        self.npch = take()    # npc >> 28 (J/JAL region bits)
        self.cq = take()      # DIV: quotient borrow (lo - cq*2^32 = q)
        self.cr = take()      # DIV: remainder borrow / sign of r
        self.sbit = take()    # LB/LH sign bit of the loaded value
        self.lbv = take()     # LB/LBU/LH/LHU loaded (unextended) value
        self.moff = take(4)   # one-hot byte offset (addr & 3, big-endian)
        self.mq = take()      # maddr low byte / 4 (alignment witness)
        self.mold_b = take(4)  # big-endian bytes of mold
        self.rt_b = take(4)   # big-endian bytes of rtv (stores/merges)
        # syscall block
        self.sk = {k: take() for k in SYS_KINDS}
        self.heap = take()    # mmap heap pointer (state)
        self.po = take()      # preimage stream offset (state)
        self.pk_b = take(32)  # preimage key bytes (state, big-endian)
        self.noh = take(5)    # one-hot n in 0..4 (preimage read/write size)
        self.sb = take(4)     # preimage stream bytes written to memory
        self.slen = take()    # preimage stream length (8 + |preimage|)
        self.sinv = take()    # syscall disambiguation inverse witness
        self.sinv2 = take()   # second inverse witness
        self.pad12 = take()   # mmap: alloc - size, in [0, 4096)
        self.isel = take()    # boundary: initial-memory record selector
        self.iaddr = take()
        self.ival = take()
        self.fsel = take()    # boundary: final-memory record selector
        self.faddr = take()
        self.fval = take()
        self.ftime = take()
        self.ncols = i


LAYOUT = Layout()


def _signed(v: int) -> int:
    return v - TWO32 if v >= TWO32 // 2 else v


def _se(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _sext16(v: int) -> int:
    v &= 0xFFFF
    return v - (1 << 16) if v & 0x8000 else v


def decode(word: int) -> Instr:
    """Decode a 32-bit MIPS instruction word (interpreter.rs
    decode_instruction capability, supported subset)."""
    opcode = (word >> 26) & 0x3F
    rs = (word >> 21) & 31
    rt = (word >> 16) & 31
    rd = (word >> 11) & 31
    sa = (word >> 6) & 31
    funct = word & 0x3F
    imm16 = word & 0xFFFF
    target = word & 0x3FFFFFF
    if opcode == 0:
        table = {
            0x00: Instr("SLL", rd=rd, rt=rt, imm=sa),
            0x02: Instr("SRL", rd=rd, rt=rt, imm=sa),
            0x03: Instr("SRA", rd=rd, rt=rt, imm=sa),
            0x04: Instr("SLLV", rd=rd, rs=rs, rt=rt),
            0x06: Instr("SRLV", rd=rd, rs=rs, rt=rt),
            0x07: Instr("SRAV", rd=rd, rs=rs, rt=rt),
            0x08: Instr("JR", rs=rs),
            0x09: Instr("JALR", rd=rd, rs=rs),
            0x0A: Instr("MOVZ", rd=rd, rs=rs, rt=rt),
            0x0B: Instr("MOVN", rd=rd, rs=rs, rt=rt),
            0x0C: Instr("SYSCALL"),
            0x0F: Instr("SYNC"),
            0x10: Instr("MFHI", rd=rd),
            0x11: Instr("MTHI", rs=rs),
            0x12: Instr("MFLO", rd=rd),
            0x13: Instr("MTLO", rs=rs),
            0x18: Instr("MULT", rs=rs, rt=rt),
            0x19: Instr("MULTU", rs=rs, rt=rt),
            0x1A: Instr("DIV", rs=rs, rt=rt),
            0x1B: Instr("DIVU", rs=rs, rt=rt),
            0x20: Instr("ADD", rd=rd, rs=rs, rt=rt),
            0x21: Instr("ADDU", rd=rd, rs=rs, rt=rt),
            0x22: Instr("SUB", rd=rd, rs=rs, rt=rt),
            0x23: Instr("SUBU", rd=rd, rs=rs, rt=rt),
            0x24: Instr("AND", rd=rd, rs=rs, rt=rt),
            0x25: Instr("OR", rd=rd, rs=rs, rt=rt),
            0x26: Instr("XOR", rd=rd, rs=rs, rt=rt),
            0x27: Instr("NOR", rd=rd, rs=rs, rt=rt),
            0x2A: Instr("SLT", rd=rd, rs=rs, rt=rt),
            0x2B: Instr("SLTU", rd=rd, rs=rs, rt=rt),
        }
        if funct in table:
            return table[funct]
        raise ValueError(f"unsupported R funct {funct:#x}")
    if opcode == 1:  # REGIMM
        regimm = {
            0x00: "BLTZ", 0x01: "BGEZ", 0x10: "BLTZAL", 0x11: "BGEZAL",
        }
        if rt in regimm:
            return Instr(regimm[rt], rs=rs, imm=_sext16(imm16))
        raise ValueError(f"unsupported regimm rt {rt:#x}")
    table = {
        0x02: Instr("J", imm=target),
        0x03: Instr("JAL", imm=target),
        0x04: Instr("BEQ", rs=rs, rt=rt, imm=_sext16(imm16)),
        0x05: Instr("BNE", rs=rs, rt=rt, imm=_sext16(imm16)),
        0x06: Instr("BLEZ", rs=rs, imm=_sext16(imm16)),
        0x07: Instr("BGTZ", rs=rs, imm=_sext16(imm16)),
        0x08: Instr("ADDI", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x09: Instr("ADDIU", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x0A: Instr("SLTI", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x0B: Instr("SLTIU", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x0C: Instr("ANDI", rt=rt, rs=rs, imm=imm16),
        0x0D: Instr("ORI", rt=rt, rs=rs, imm=imm16),
        0x0E: Instr("XORI", rt=rt, rs=rs, imm=imm16),
        0x0F: Instr("LUI", rt=rt, imm=imm16),
        0x20: Instr("LB", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x21: Instr("LH", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x22: Instr("LWL", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x23: Instr("LW", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x24: Instr("LBU", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x25: Instr("LHU", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x26: Instr("LWR", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x28: Instr("SB", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x29: Instr("SH", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x2A: Instr("SWL", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x2B: Instr("SW", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x2E: Instr("SWR", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x30: Instr("LL", rt=rt, rs=rs, imm=_sext16(imm16)),
        0x38: Instr("SC", rt=rt, rs=rs, imm=_sext16(imm16)),
    }
    if opcode in table:
        return table[opcode]
    raise ValueError(f"unsupported opcode {opcode:#x}")


PAGE = 4096


def _align_up(size: int) -> int:
    return ((size + PAGE - 1) // PAGE) * PAGE


def execute(program: list[Instr], max_steps: int, regs0=None, memory=None,
            *, pc0: int = 0, heap0: int = 0, po0: int = 0,
            pk0: bytes = b"\x00" * 32, preimages: dict | None = None,
            hi0: int = 0, lo0: int = 0):
    """Concrete execution with the Cannon pc/npc delay-slot model,
    bit-exact to cannon.CannonVM.step for the full ISA (big-endian
    aligned-word memory, syscalls with preimage-oracle semantics).
    `program[w]` is the instruction at pc = pc0 + 4*w. Returns
    (rows, final_state); rows carry per-step memory access metadata
    (old value, last access time) for the RAM argument plus syscall
    metadata for the syscall constraint rows."""
    regs = list(regs0 or [0] * 32)
    regs[0] = 0
    mem = dict(memory or {})          # aligned byte addr -> BE word
    init_mem = dict(memory or {})
    last_access: dict[int, int] = {}
    preimages = preimages or {}
    pc, npc = pc0, pc0 + 4
    hi, lo = hi0, lo0
    heap, po = heap0, po0
    pk = bytearray(pk0)
    assert len(pk) == 32
    exited = False
    exit_code = 0
    rows = []

    def mem_word(aligned: int) -> int:
        init_mem.setdefault(aligned, 0)
        return mem.get(aligned, 0)

    def stream() -> bytes:
        data = preimages.get(bytes(pk))
        if data is None:
            raise ValueError(f"unknown preimage key {bytes(pk).hex()}")
        return len(data).to_bytes(8, "big") + data

    for step in range(max_steps):
        if exited:
            break
        word_idx = (pc - pc0) // 4
        if word_idx < 0 or word_idx >= len(program):
            break
        ins = program[word_idx]
        t = step + 1  # idx column value on this row
        row = {
            "pc": pc, "npc": npc, "hi": hi, "lo": lo,
            "regs": list(regs), "instr": ins, "t": t,
            "heap": heap, "po": po, "pk": bytes(pk),
        }
        a = regs[ins.rs]
        b = regs[ins.rt]
        imm = ins.imm
        res = 0
        flag = 0
        new_npc = (npc + 4) % TWO32
        wreg = None

        def access(aligned: int, new_word: int | None):
            """Record one word access (read keeps the word)."""
            old = mem_word(aligned)
            row["maddr"] = aligned
            row["mold"] = old
            row["mlast"] = last_access.get(aligned, 0)
            last_access[aligned] = t + 1
            if new_word is None:
                row["mval"] = old
                return old
            row["mval"] = new_word
            mem[aligned] = new_word
            return old

        if ins.op in ("ADD", "ADDU"):
            total = a + b
            flag, res = divmod(total, TWO32)
            wreg = ins.rd
        elif ins.op in ("SUB", "SUBU"):
            flag = 1 if a < b else 0
            res = (a - b) % TWO32
            wreg = ins.rd
        elif ins.op in ("ADDI", "ADDIU"):
            total = a + imm
            res = total % TWO32
            flag = (total - res) // TWO32  # signed carry in {-1, 0, 1}
            wreg = ins.rt
        elif ins.op == "LUI":
            res = ((imm & 0xFFFF) << 16) % TWO32
            wreg = ins.rt
        elif ins.op == "SLT":
            res = 1 if _signed(a) < _signed(b) else 0
            wreg = ins.rd
        elif ins.op == "SLTU":
            res = 1 if a < b else 0
            wreg = ins.rd
        elif ins.op == "SLTI":
            res = 1 if _signed(a) < imm else 0
            wreg = ins.rt
        elif ins.op == "SLTIU":
            res = 1 if a < imm % TWO32 else 0
            wreg = ins.rt
        elif ins.op in SHIFTS:
            sa = (imm if ins.op in CONST_SHIFTS else a) & 31
            row["sa"] = sa
            if ins.op in ("SLL", "SLLV"):
                total = b << sa
                flag, res = total >> 32, total % TWO32
            elif ins.op in ("SRL", "SRLV"):
                res = b >> sa
                flag = b & ((1 << sa) - 1)
            else:  # SRA / SRAV: arithmetic shift
                res = (_signed(b) >> sa) % TWO32
                flag = b & ((1 << sa) - 1)
            wreg = ins.rd
        elif ins.op == "MULT":
            sprod = _signed(a) * _signed(b)
            flag = 1 if sprod < 0 else 0  # product sign (constraint witness)
            total = sprod % (1 << 64)
            hi, lo = total >> 32, total % TWO32
            res = lo
        elif ins.op == "MULTU":
            total = a * b
            hi, lo = divmod(total, TWO32)
            res = lo
        elif ins.op in ("DIV", "DIVU"):
            flag = 1 if b == 0 else 0  # divisor-zero (hi/lo unchanged)
            if b != 0:
                if ins.op == "DIV":
                    sa_, sb_ = _signed(a), _signed(b)
                    q = abs(sa_) // abs(sb_)
                    if (sa_ < 0) != (sb_ < 0):
                        q = -q
                    lo, hi = q % TWO32, (sa_ - sb_ * q) % TWO32
                else:
                    lo, hi = a // b, a % b
            res = lo
        elif ins.op == "MFLO":
            res = lo
            wreg = ins.rd
        elif ins.op == "MFHI":
            res = hi
            wreg = ins.rd
        elif ins.op == "MTLO":
            lo = a
        elif ins.op == "MTHI":
            hi = a
        elif ins.op in ("MOVZ", "MOVN"):
            res = a
            flag = 1 if b == 0 else 0  # zf witness
            if (b == 0) == (ins.op == "MOVZ"):
                wreg = ins.rd
        elif ins.op == "SYNC":
            pass
        elif ins.op in ("BEQ", "BNE"):
            flag = 1 if a == b else 0
            taken = flag if ins.op == "BEQ" else 1 - flag
            new_npc = (npc + 4 * imm) % TWO32 if taken else (npc + 4) % TWO32
        elif ins.op in BRANCH_Z:
            s = _signed(a)
            taken = {
                "BLTZ": s < 0, "BLTZAL": s < 0,
                "BGEZ": s >= 0, "BGEZAL": s >= 0,
                "BLEZ": s <= 0, "BGTZ": s > 0,
            }[ins.op]
            flag = int(taken)
            new_npc = (npc + 4 * imm) % TWO32 if taken else (npc + 4) % TWO32
            if ins.op in ("BLTZAL", "BGEZAL"):
                res = (npc + 4) % TWO32
                wreg = 31
        elif ins.op in ("J", "JAL"):
            new_npc = ((npc & 0xF0000000) | (4 * imm)) % TWO32
            if ins.op == "JAL":
                res = (npc + 4) % TWO32
                wreg = 31
        elif ins.op == "JR":
            new_npc = a
        elif ins.op == "JALR":
            res = (npc + 4) % TWO32
            wreg = ins.rd
            new_npc = a
        elif ins.op in R_BITWISE:
            res = {
                "AND": a & b, "OR": a | b, "XOR": a ^ b,
                "NOR": (~(a | b)) % TWO32,
            }[ins.op]
            wreg = ins.rd
        elif ins.op in I_BITWISE:
            m = imm & 0xFFFF
            res = {"ANDI": a & m, "ORI": a | m, "XORI": a ^ m}[ins.op]
            wreg = ins.rt
        elif ins.op in MEM_OPS:
            addr = (a + imm) % TWO32
            off = addr & 3
            aligned = addr - off
            row["moff"] = off
            old = mem_word(aligned)
            ob = old.to_bytes(4, "big")
            if ins.op in ("LW", "LL"):
                res = access(aligned, None)
                wreg = ins.rt
            elif ins.op == "LB":
                res = _se(ob[off], 8) % TWO32
                access(aligned, None)
                wreg = ins.rt
            elif ins.op == "LBU":
                res = ob[off]
                access(aligned, None)
                wreg = ins.rt
            elif ins.op in ("LH", "LHU"):
                h = (off & 2) >> 1
                hv = (ob[2 * h] << 8) | ob[2 * h + 1]
                res = _se(hv, 16) % TWO32 if ins.op == "LH" else hv
                access(aligned, None)
                wreg = ins.rt
            elif ins.op == "LWL":
                val = (old << (off * 8)) % TWO32
                mask = (0xFFFFFFFF << (off * 8)) % TWO32
                res = (b & ~mask & 0xFFFFFFFF) | val
                access(aligned, None)
                wreg = ins.rt
            elif ins.op == "LWR":
                sh = 24 - off * 8
                val = old >> sh
                mask = 0xFFFFFFFF >> sh
                res = (b & ~mask & 0xFFFFFFFF) | val
                access(aligned, None)
                wreg = ins.rt
            elif ins.op in ("SW", "SC"):
                access(aligned, b)
                if ins.op == "SC":
                    res = 1
                    wreg = ins.rt
            elif ins.op == "SB":
                nb = bytearray(ob)
                nb[off] = b & 0xFF
                access(aligned, int.from_bytes(nb, "big"))
            elif ins.op == "SH":
                h = (off & 2) >> 1
                nb = bytearray(ob)
                nb[2 * h] = (b >> 8) & 0xFF
                nb[2 * h + 1] = b & 0xFF
                access(aligned, int.from_bytes(nb, "big"))
            elif ins.op == "SWL":
                val = b >> (off * 8)
                mask = 0xFFFFFFFF >> (off * 8)
                access(aligned, (old & ~mask & 0xFFFFFFFF) | val)
            elif ins.op == "SWR":
                sh = 24 - off * 8
                val = (b << sh) % TWO32
                mask = (0xFFFFFFFF << sh) % TWO32
                access(aligned, (old & ~mask & 0xFFFFFFFF) | val)
        elif ins.op == "SYSCALL":
            num = regs[2]
            a0, a1, a2 = regs[4], regs[5], regs[6]
            v0 = v1 = 0
            kind = "other"
            if num == SYS_MMAP:
                if a0 == 0:
                    kind = "mmap0"
                    alloc = _align_up(a1)
                    row["alloc"] = alloc
                    v0 = heap
                    heap = (heap + alloc) % TWO32
                else:
                    kind = "mmap1"
                    v0 = a0
            elif num == SYS_BRK:
                kind, v0 = "brk", BRK_BASE
            elif num == SYS_CLONE:
                kind, v0 = "clone", 1
            elif num == SYS_EXIT:
                kind = "exit"
                exited, exit_code = True, a0 & 0xFF
                new_npc = npc  # pc/npc not advanced on exit (cannon.py)
            elif num == SYS_READ:
                if a0 == FD_STDIN:
                    kind = "rstdin"
                elif a0 == FD_HINT_READ:
                    kind, v0 = "rhint", a2
                elif a0 == FD_PRE_READ:
                    kind = "rpre"
                    dat = stream()
                    off = a1 & 3
                    aligned = a1 - off
                    n = max(0, min(a2, 4 - off, len(dat) - po))
                    row["moff"] = off
                    row["n"] = n
                    row["slen"] = len(dat)
                    row["sb"] = [dat[po + i] if i < n else 0 for i in range(4)]
                    old = mem_word(aligned)
                    nb = bytearray(old.to_bytes(4, "big"))
                    for i in range(n):
                        nb[off + i] = dat[po + i]
                    if n > 0:
                        access(aligned, int.from_bytes(nb, "big"))
                    po += n
                    v0 = n
                else:
                    kind, v0, v1 = "rbad", 0xFFFFFFFF, 0x9
            elif num == SYS_WRITE:
                if a0 in (FD_STDOUT, FD_STDERR):
                    kind, v0 = "wout", a2
                elif a0 == FD_HINT_WRITE:
                    kind, v0 = "whint", a2
                elif a0 == FD_PRE_WRITE:
                    kind = "wpre"
                    off = a1 & 3
                    aligned = a1 - off
                    n = min(a2, 4 - off)
                    row["moff"] = off
                    row["n"] = n
                    old = mem_word(aligned)
                    ob = old.to_bytes(4, "big")
                    if n > 0:
                        access(aligned, None)
                    dat = bytes(ob[off + i] for i in range(n))
                    pk = bytearray(bytes(pk[n:]) + dat)
                    po = 0
                    v0 = n
                else:
                    kind, v0, v1 = "wbad", 0xFFFFFFFF, 0x9
            elif num == SYS_FCNTL:
                if a1 != 3:  # != F_GETFL
                    kind, v0, v1 = "fceinval", 0xFFFFFFFF, 0x16
                elif a0 in (FD_STDIN, FD_HINT_READ, FD_PRE_READ):
                    kind, v0 = "fcr", 0
                elif a0 in (FD_STDOUT, FD_STDERR, FD_HINT_WRITE, FD_PRE_WRITE):
                    kind, v0 = "fcw", 1
                else:
                    kind, v0, v1 = "fcbadf", 0xFFFFFFFF, 0x9
            row["sys_kind"] = kind
            if kind != "exit":
                regs[2] = v0 & 0xFFFFFFFF
                regs[7] = v1
        else:
            raise ValueError(f"unsupported op {ins.op}")
        row["res"] = res
        row["flag"] = flag
        rows.append(row)
        if wreg is not None and wreg != 0:
            regs[wreg] = res
        if not exited:
            pc, npc = npc, new_npc
    state = {
        "regs": regs, "hi": hi, "lo": lo, "pc": pc, "npc": npc,
        "memory": mem, "init_memory": init_mem, "last_access": last_access,
        "heap": heap, "po": po, "pk": bytes(pk),
        "exited": exited, "exit_code": exit_code,
    }
    return rows, state


# ---------------------------------------------------------------------------
# witness columns
# ---------------------------------------------------------------------------


def _bytes4(v: int) -> list[int]:
    return [(v >> (8 * k)) & 0xFF for k in range(4)]


def rom_table(f: FieldParams, program: list[Instr], pc0: int = 0) -> FixedTable:
    """(pc, descriptor, imm) per program word; the descriptor packs
    (op_id, write_dest, rs, rt) which are each canonically bounded, and
    imm rides as its own vector component so the packing is
    collision-free."""
    pcs, descs, imms = [], [], []
    for w, ins in enumerate(program):
        pcs.append(pc0 + 4 * w)
        descs.append(
            OP_ID[ins.op] + (write_dest(ins) << 6) + (ins.rs << 11) + (ins.rt << 16)
        )
        imms.append(ins.imm % f.p)
    return FixedTable(TBL_ROM, "rom", [pcs, descs, imms])


def preimage_tables(preimages: dict[bytes, bytes] | None) -> list[FixedTable]:
    """PREIMAGE: (key_hi, key_lo, offset, stream_byte, stream_len) per
    byte of each key's length-prefixed stream; PRELEN: (key_hi, key_lo,
    stream_len) per key — pins slen on every preimage-read row even
    when n = 0. Keys ride as two 128-bit halves (deg-1 combinations of
    the 32 pk byte columns). The all-zero padding row means the zero
    key reads as an empty stream — reads of genuinely absent keys are
    unprovable (and abort the host oracle, cannon.py)."""
    khis, klos, offs, bys, lens = [], [], [], [], []
    lhs, lls, lns = [], [], []
    for key in sorted(preimages or {}):
        data = preimages[key]
        stream = len(data).to_bytes(8, "big") + data
        khi = int.from_bytes(key[:16], "big")
        klo = int.from_bytes(key[16:], "big")
        lhs.append(khi)
        lls.append(klo)
        lns.append(len(stream))
        for o, byv in enumerate(stream):
            khis.append(khi)
            klos.append(klo)
            offs.append(o)
            bys.append(byv)
            lens.append(len(stream))
    khis.append(0), klos.append(0), offs.append(0), bys.append(0), lens.append(0)
    lhs.append(0), lls.append(0), lns.append(0)
    return [
        FixedTable(TBL_PREIMAGE, "preimage", [khis, klos, offs, bys, lens]),
        FixedTable(TBL_PRELEN, "preimage_len", [lhs, lls, lns]),
    ]


def pow2_table() -> FixedTable:
    sas = list(range(32))
    return FixedTable(
        TBL_POW2, "pow2", [sas, [1 << s for s in sas], [1 << (32 - s) for s in sas]]
    )


def byte_table() -> FixedTable:
    return FixedTable(TBL_BYTE, "byte", [list(range(256))])


def build_columns(f: FieldParams, rows, state, n: int, L: Layout | None = None) -> list[list[int]]:
    """Witness columns (L.ncols x n). Row len(rows) holds the
    final machine state (register consistency reads NEXT); padding rows
    after it host one initial-memory and one final-memory boundary
    record each."""
    L = L or LAYOUT
    p = f.p
    init_mem = state["init_memory"]
    nboundary = len(init_mem)
    assert len(rows) + 1 + nboundary <= n, "trace + boundary rows exceed domain"
    cols = [[0] * n for _ in range(L.ncols)]
    for i, row in enumerate(rows):
        ins: Instr = row["instr"]
        a = row["regs"][ins.rs]
        b = row["regs"][ins.rt]
        res = row["res"]
        flag = row["flag"]
        cols[L.pc][i] = row["pc"]
        cols[L.npc][i] = row["npc"]
        cols[L.hi][i] = row["hi"]
        cols[L.lo][i] = row["lo"]
        for r in range(32):
            cols[L.regs[r]][i] = row["regs"][r]
        cols[L.sel[ins.op]][i] = 1
        cols[L.rd_oh[write_dest(ins)]][i] = 1
        cols[L.rs_oh[ins.rs]][i] = 1
        cols[L.rt_oh[ins.rt]][i] = 1
        cols[L.imm][i] = ins.imm % p
        cols[L.res][i] = res
        cols[L.flag][i] = flag % p
        cols[L.idx][i] = row["t"]
        cols[L.heap][i] = row["heap"]
        cols[L.po][i] = row["po"]
        for k in range(32):
            cols[L.pk_b[k]][i] = row["pk"][k]
        for k, bv in enumerate(_bytes4(res)):
            cols[L.res_b[k]][i] = bv

        auxa = auxb = auxc = auxd = auxe = auxf = 0
        nxt_hi = rows[i + 1]["hi"] if i + 1 < len(rows) else state["hi"]
        nxt_lo = rows[i + 1]["lo"] if i + 1 < len(rows) else state["lo"]
        if ins.op in ("BEQ", "BNE"):
            diff = (a - b) % p
            cols[L.inv][i] = pow(diff, -1, p) if diff else 0
        if ins.op in ("BLEZ", "BGTZ"):
            cols[L.zf][i] = 1 if a == 0 else 0
            cols[L.inv][i] = pow(a, -1, p) if a else 0
        if ins.op in ("MOVZ", "MOVN", "DIV", "DIVU"):
            cols[L.zf][i] = 1 if b == 0 else 0
            cols[L.inv][i] = pow(b, -1, p) if b else 0
        if ins.op in ("MULT", "MULTU"):
            # hi AFTER the op (constraint uses hi_next): next row's hi
            auxa = nxt_hi
        if ins.op in ("DIV", "DIVU") and b != 0:
            auxa = nxt_hi  # remainder (mod 2^32)
            if ins.op == "DIVU":
                auxd = b - nxt_hi - 1  # r < b
            else:
                sa_, sb_ = _signed(a), _signed(b)
                q = abs(sa_) // abs(sb_)
                if (sa_ < 0) != (sb_ < 0):
                    q = -q
                r = sa_ - sb_ * q
                cols[L.cq][i] = 1 if q < 0 else 0
                cols[L.cr][i] = 1 if r < 0 else 0
                auxd = abs(sb_) - abs(r) - 1  # |r| < |b|
        if ins.op == "MULT" or ins.op in ("SLT", "SLTI") or ins.op == "DIV" \
                or ins.op in BRANCH_Z:
            cols[L.msb_a][i] = a >> 31
            auxb = (2 * (a - (a >> 31) * (1 << 31))) % TWO32
        if ins.op in ("MULT", "SLT", "SRA", "SRAV", "DIV"):
            cols[L.msb_b][i] = b >> 31
            auxc = 2 * (b - (b >> 31) * (1 << 31))
        if ins.op in ("J", "JAL"):
            cols[L.npch][i] = row["npc"] >> 28
            auxe = row["npc"] & ((1 << 28) - 1)
            auxf = 16 * (auxe >> 24)
        if ins.op in COMPARES:
            if ins.op == "SLT":
                d = a - b + (1 << 31) * (2 * (b >> 31) - 2 * (a >> 31)) + res * TWO32
            elif ins.op == "SLTU":
                d = a - b + res * TWO32
            else:
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
                cols[L.shq][i] = (a - sa) // 32
                auxd = (a - sa) // 32
        if ins.op in MEM_OPS:
            off = row["moff"]
            cols[L.moff[off]][i] = 1
            cols[L.maddr][i] = row["maddr"]
            cols[L.mq][i] = (row["maddr"] & 0xFF) >> 2
            cols[L.mold][i] = row["mold"]
            cols[L.mval][i] = row["mval"]
            cols[L.mlast][i] = row["mlast"]
            total = a + ins.imm
            cols[L.mcarry][i] = (total - row["maddr"] - off) // TWO32 % p
            auxa = row["maddr"]
            auxb = row["t"] - row["mlast"]
            assert auxb >= 0
            ob = row["mold"].to_bytes(4, "big")
            if ins.op in SUBWORD:
                for k in range(4):
                    cols[L.mold_b[k]][i] = ob[k]
            if ins.op in RT_BYTE_OPS:
                for k, bv in enumerate(b.to_bytes(4, "big")):
                    cols[L.rt_b[k]][i] = bv
            if ins.op in ("LB", "LBU"):
                lbv = ob[off]
                sbit = (lbv >> 7) if ins.op == "LB" else 0
                cols[L.lbv][i] = lbv
                cols[L.sbit][i] = sbit
                auxc = 2 * (lbv - 128 * sbit)
            elif ins.op in ("LH", "LHU"):
                h = (off & 2) >> 1
                hv = (ob[2 * h] << 8) | ob[2 * h + 1]
                sbit = (hv >> 15) if ins.op == "LH" else 0
                cols[L.lbv][i] = hv
                cols[L.sbit][i] = sbit
                auxc = 2 * (hv - (1 << 15) * sbit)
        if ins.op == "SYSCALL":
            kind = row["sys_kind"]
            cols[L.sk[kind]][i] = 1
            num = row["regs"][2]
            a0, a1, a2 = row["regs"][4], row["regs"][5], row["regs"][6]

            def _inv(v):
                return pow(v % p, -1, p) if v % p else 0

            if kind == "mmap0":
                alloc = row["alloc"]
                auxe = alloc >> 12
                pad12 = alloc - a1
                cols[L.pad12][i] = pad12
                auxf = 16 * pad12
                # res = new heap (byte-bounded via res_b); flag = carry
                # (execute leaves res/flag 0 on syscall rows — recompute)
                new_heap = row["heap"] + alloc
                flag = new_heap // TWO32
                res = new_heap % TWO32
                cols[L.flag][i] = flag
                cols[L.res][i] = res
                for k, bv in enumerate(_bytes4(res)):
                    cols[L.res_b[k]][i] = bv
            elif kind == "mmap1":
                cols[L.sinv][i] = _inv(a0)
            elif kind == "other":
                p1 = 1
                for s in (SYS_MMAP, SYS_BRK, SYS_CLONE, SYS_EXIT):
                    p1 = p1 * (num - s) % p
                p2 = 1
                for s in (SYS_READ, SYS_WRITE, SYS_FCNTL):
                    p2 = p2 * (num - s) % p
                cols[L.sinv][i] = _inv(p1)
                cols[L.sinv2][i] = _inv(p2)
            elif kind == "rbad":
                cols[L.sinv][i] = _inv(a0 * (a0 - 3) * (a0 - 5))
            elif kind == "wbad":
                cols[L.sinv][i] = _inv((a0 - 1) * (a0 - 2) * (a0 - 4) * (a0 - 6))
            elif kind == "fceinval":
                cols[L.sinv][i] = _inv(a1 - 3)
            elif kind == "fcbadf":
                cols[L.sinv][i] = _inv(a0 * (a0 - 1) * (a0 - 2) * (a0 - 3))
                cols[L.sinv2][i] = _inv((a0 - 4) * (a0 - 5) * (a0 - 6))
            if kind in ("rpre", "wpre"):
                nn = row["n"]
                off = row["moff"]
                cols[L.noh[nn]][i] = 1
                cols[L.moff[off]][i] = 1
                maddr = a1 - off
                cols[L.maddr][i] = maddr
                cols[L.mq][i] = (maddr & 0xFF) >> 2
                auxa = maddr
                auxc = a2 - nn
                auxd = 4 - off - nn
                if nn > 0:
                    cols[L.mold][i] = row["mold"]
                    cols[L.mval][i] = row["mval"]
                    cols[L.mlast][i] = row["mlast"]
                    auxb = row["t"] - row["mlast"]
                    for k, bv in enumerate(row["mold"].to_bytes(4, "big")):
                        cols[L.mold_b[k]][i] = bv
                if kind == "rpre":
                    cols[L.slen][i] = row["slen"]
                    auxe = row["slen"] - row["po"] - nn
                    for k in range(4):
                        cols[L.sb[k]][i] = row["sb"][k]
        for k, bv in enumerate(_bytes4(auxa)):
            cols[L.auxa_b[k]][i] = bv
        for k, bv in enumerate(_bytes4(auxb)):
            cols[L.auxb_b[k]][i] = bv
        for k, bv in enumerate(_bytes4(auxc)):
            cols[L.auxc_b[k]][i] = bv
        for k, bv in enumerate(_bytes4(auxd)):
            cols[L.auxd_b[k]][i] = bv
        for k, bv in enumerate(_bytes4(auxe)):
            cols[L.auxe_b[k]][i] = bv
        for k, bv in enumerate(_bytes4(auxf)):
            cols[L.auxf_b[k]][i] = bv
        if ins.op in BITWISE:
            bop = b if ins.op in R_BITWISE else (ins.imm & 0xFFFF)
            bw = L.bw_bits
            mask = (1 << bw) - 1
            for k in range(len(L.an)):
                cols[L.an[k]][i] = (a >> (bw * k)) & mask
                cols[L.bn[k]][i] = (bop >> (bw * k)) & mask
                cols[L.zn[k]][i] = (res >> (bw * k)) & mask

    # final-state row
    fin = len(rows)
    for r in range(32):
        cols[L.regs[r]][fin] = state["regs"][r]
    cols[L.pc][fin] = state["pc"]
    cols[L.npc][fin] = state["npc"]
    cols[L.hi][fin] = state["hi"]
    cols[L.lo][fin] = state["lo"]
    cols[L.idx][fin] = len(rows) + 1
    cols[L.heap][fin] = state["heap"]
    cols[L.po][fin] = state["po"]
    for k in range(32):
        cols[L.pk_b[k]][fin] = state["pk"][k]

    # boundary rows: one initial-memory + one final-memory record each
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


def make_logup(f: FieldParams, program: list[Instr], n: int,
               L: Layout | None = None, preimages: dict | None = None,
               pc0: int = 0) -> MultiLogup:
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

    # ROM pinning: (pc, descriptor, imm)
    rd_e: E.Expr = E.Literal(0)
    rs_e: E.Expr = E.Literal(0)
    rt_e: E.Expr = E.Literal(0)
    for r in range(32):
        rd_e = rd_e + E.Literal(r) * _c(L.rd_oh[r])
        rs_e = rs_e + E.Literal(r) * _c(L.rs_oh[r])
        rt_e = rt_e + E.Literal(r) * _c(L.rt_oh[r])
    opid_e: E.Expr = E.Literal(0)
    for op in OPS:
        opid_e = opid_e + E.Literal(OP_ID[op]) * sel[op]
    desc = (
        opid_e
        + E.Literal(1 << 6) * rd_e
        + E.Literal(1 << 11) * rs_e
        + E.Literal(1 << 16) * rt_e
    )
    specs.append(LookupSpec(TBL_ROM, sel_any, [_c(L.pc), desc, _c(L.imm)]))

    # byte range checks (always-on; 0 is in the table so padding is free)
    for group in (L.res_b, L.auxa_b, L.auxb_b, L.auxc_b, L.auxd_b,
                  L.auxe_b, L.auxf_b, L.mold_b, L.rt_b):
        for ci in group:
            specs.append(LookupSpec(TBL_BYTE, one, [_c(ci)]))
    specs.append(LookupSpec(TBL_BYTE, one, [_c(L.mq)]))

    # bitwise nibbles
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

    # shifts: pin (sa, 2^sa, 2^{32-sa})
    specs.append(
        LookupSpec(TBL_POW2, sel_sum(SHIFTS), [_c(L.sa), _c(L.pw), _c(L.pw2b)])
    )

    # memory RAM records (reference sign convention, ramlookup.rs:46-51:
    # write -> +, read -> -; access = write(addr,last,old), read(addr,t+1,new)).
    # Preimage-fd syscall rows access memory too, unless n = 0.
    sk_pre = _c(L.sk["rpre"]) + _c(L.sk["wpre"])
    mem_acc = sel_sum(MEM_OPS) + sk_pre * (one - _c(L.noh[0]))
    specs.append(
        LookupSpec(TBL_MEMORY, mem_acc, [_c(L.maddr), _c(L.mlast), _c(L.mold)])
    )
    specs.append(
        LookupSpec(
            TBL_MEMORY,
            E.Literal(0) - mem_acc,
            [_c(L.maddr), _c(L.idx) + one, _c(L.mval)],
        )
    )
    # boundary records: initial memory consumed (read), final produced (write)
    specs.append(
        LookupSpec(
            TBL_MEMORY, E.Literal(0) - _c(L.isel), [_c(L.iaddr), E.Literal(0), _c(L.ival)]
        )
    )
    specs.append(
        LookupSpec(TBL_MEMORY, _c(L.fsel), [_c(L.faddr), _c(L.ftime), _c(L.fval)])
    )

    # preimage stream reads: each of the n stream bytes written this row
    # is pinned to (key, po + i, byte, len); the PRELEN lookup pins slen
    # whenever sk[rpre] = 1 (even at n = 0, closing the fake-slen hole)
    khi: E.Expr = E.Literal(0)
    klo: E.Expr = E.Literal(0)
    for k in range(16):
        khi = khi + E.Literal(1 << (8 * (15 - k))) * _c(L.pk_b[k])
        klo = klo + E.Literal(1 << (8 * (15 - k))) * _c(L.pk_b[16 + k])
    sk_rpre = _c(L.sk["rpre"])
    for i in range(4):
        ind_i: E.Expr = E.Literal(0)
        for m in range(i + 1, 5):
            ind_i = ind_i + _c(L.noh[m])
        specs.append(LookupSpec(
            TBL_PREIMAGE, sk_rpre * ind_i,
            [khi, klo, _c(L.po) + E.Literal(i), _c(L.sb[i]), _c(L.slen)],
        ))
    specs.append(LookupSpec(TBL_PRELEN, sk_rpre, [khi, klo, _c(L.slen)]))

    tables = [byte_table(), bitwise_table(TBL_BITWISE, L.bw_bits), pow2_table(),
              rom_table(f, program, pc0)] + preimage_tables(preimages)
    return MultiLogup(f, specs, tables, n, L.ncols)


def constraints(
    f: FieldParams,
    logup: MultiLogup,
    k_steps: int,
    regs0: list[int] | None = None,
    final_state: dict | None = None,
    omega: int | None = None,
    L: Layout | None = None,
    init: dict | None = None,
) -> list[E.Expr]:
    """Selector-gated MIPS semantics + lookup constraints + boundary
    pinning at rows 0 and k_steps (the public statement). `omega` is
    the d1 generator (needed to exempt the wraparound row from the
    contiguity constraint). `init` optionally pins the non-register
    initial machine state {pc, hi, lo, heap, po, pk} (defaults: all
    zero, pc=0 — the Cannon snapshot fields, cannon.py State)."""
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

    rsv: E.Expr = E.Literal(0)
    rtv: E.Expr = E.Literal(0)
    for r in range(32):
        rsv = rsv + _c(L.rs_oh[r]) * _c(L.regs[r])
        rtv = rtv + _c(L.rt_oh[r]) * _c(L.regs[r])

    imm = _c(L.imm)
    res = _c(L.res)
    flag = _c(L.flag)
    inv = _c(L.inv)
    idx = _c(L.idx)
    pc, npc = _c(L.pc), _c(L.npc)
    pc_n, npc_n = _c(L.pc, E.NEXT), _c(L.npc, E.NEXT)
    hi, lo = _c(L.hi), _c(L.lo)
    hi_n, lo_n = _c(L.hi, E.NEXT), _c(L.lo, E.NEXT)
    two32 = E.Literal(TWO32 % p)
    two31 = E.Literal(1 << 31)

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
    # selector structure
    for op in OPS:
        out.append(sel[op].boolean())
    out.append(sel_any * (sel_any - one))
    # Executing rows form a contiguous prefix (timestamp uniqueness for
    # the memory argument): once sel_any drops to 0 it stays 0 — except
    # across the cyclic wraparound row n-1, which is exempted by the
    # normalized Lagrange indicator l_{n-1}(x) = L̂_{n-1}(x)·w^{n-1}/n.
    sel_any_next: E.Expr = E.Literal(0)
    for op in OPS:
        sel_any_next = sel_any_next + _c(L.sel[op], E.NEXT)
    assert omega is not None
    ell_last = E.UnnormalizedLagrangeBasis(n - 1) * E.Literal(
        pow(omega, n - 1, p) * pow(n, -1, p) % p
    )
    out.append((one - ell_last) * sel_any_next * (one - sel_any))
    for group in (L.rd_oh, L.rs_oh, L.rt_oh):
        total: E.Expr = E.Literal(0)
        for i in group:
            out.append(_c(i).boolean())
            total = total + _c(i)
        out.append(total - sel_any)
    out.append(_c(L.regs[0]))
    # time counter chain
    out.append(sel_any * (_c(L.idx, E.NEXT) - idx - one))

    # always-on result byte decomposition (bounds every register write)
    out.append(res - bytes_sum(L.res_b))

    bitflag = sel_sum(["ADD", "ADDU", "SUB", "SUBU", "BEQ", "BNE"])
    out.append(bitflag * flag.boolean())
    # ADDI signed carry in {-1, 0, 1}
    addi = sel_sum(["ADDI", "ADDIU"])
    out.append(addi * flag * (flag - one) * (flag + one))

    zf = _c(L.zf)
    sk = {k: _c(L.sk[k]) for k in SYS_KINDS}
    noh = [_c(L.noh[m]) for m in range(5)]
    n_expr: E.Expr = E.Literal(0)
    for m in range(1, 5):
        n_expr = n_expr + E.Literal(m) * noh[m]
    reg2, reg4 = _c(L.regs[2]), _c(L.regs[4])
    reg5, reg6 = _c(L.regs[5]), _c(L.regs[6])
    heap = _c(L.heap)

    # zero-flag ties (zf = [value == 0], value = rtv or rsv by op class)
    out.append(zf.boolean())
    zt_rt = sel_sum(["MOVZ", "MOVN", "DIV", "DIVU"])
    zt_rs = sel_sum(["BLEZ", "BGTZ"])
    out.append(zt_rt * rtv * zf)
    out.append(zt_rt * (rtv * inv - (one - zf)))
    out.append(zt_rs * rsv * zf)
    out.append(zt_rs * (rsv * inv - (one - zf)))

    # syscall return values (written to v0=r2, v1=r7 unless exit)
    neg1 = E.Literal(0xFFFFFFFF)
    v0x = (
        sk["mmap0"] * heap
        + sk["mmap1"] * reg4
        + sk["brk"] * E.Literal(BRK_BASE)
        + sk["clone"]
        + (sk["rpre"] + sk["wpre"]) * n_expr
        + (sk["rhint"] + sk["whint"] + sk["wout"]) * reg6
        + (sk["rbad"] + sk["wbad"] + sk["fceinval"] + sk["fcbadf"]) * neg1
        + sk["fcw"]
    )
    v1x = (sk["rbad"] + sk["wbad"] + sk["fcbadf"]) * E.Literal(0x9) + sk[
        "fceinval"
    ] * E.Literal(0x16)
    sys_w = sel["SYSCALL"] * (one - sk["exit"])

    writes = sel_sum(WRITING_OPS)
    cond_w = sel["MOVZ"] * zf + sel["MOVN"] * (one - zf)
    for r in range(32):
        reg = _c(L.regs[r])
        reg_n = _c(L.regs[r], E.NEXT)
        wr = _c(L.rd_oh[r]) * (writes + cond_w) if r != 0 else E.Literal(0)
        if r == 2:
            out.append(sel_any * (wr * (reg_n - res) + sys_w * (reg_n - v0x)
                                  + (one - wr - sys_w) * (reg_n - reg)))
        elif r == 7:
            out.append(sel_any * (wr * (reg_n - res) + sys_w * (reg_n - v1x)
                                  + (one - wr - sys_w) * (reg_n - reg)))
        else:
            out.append(sel_any * (wr * (reg_n - res) + (one - wr) * (reg_n - reg)))

    # hi/lo registers (MULT/MULTU/DIV/DIVU write both; MTHI/MTLO one)
    mults = sel_sum(["MULT", "MULTU"])
    divs = sel_sum(["DIV", "DIVU"])
    hilo_w = mults + divs * (one - zf)
    out.append(sel_any * (hilo_w * (lo_n - res) + sel["MTLO"] * (lo_n - rsv)
                          + (one - hilo_w - sel["MTLO"]) * (lo_n - lo)))
    out.append(sel_any * (sel["MTHI"] * (hi_n - rsv)
                          + (one - hilo_w - sel["MTHI"]) * (hi_n - hi)))
    hi_new = bytes_sum(L.auxa_b)
    out.append(hilo_w * (hi_n - hi_new))
    # MULTU: rs*rt = hi*2^32 + lo exactly (hi, lo byte-bounded)
    out.append(sel["MULTU"] * (rsv * rtv - res - hi_new * two32))
    # MULT: signed product; msb_h resolves uniquely (see docstring)
    msb_a, msb_b = _c(L.msb_a), _c(L.msb_b)
    a_s = rsv - msb_a * two32
    b_s = rtv - msb_b * two32
    # signed product = (hi - s*2^32)*2^32 + lo for the unique valid s;
    # expose s via flag on MULT rows (boolean)
    out.append(sel["MULT"] * flag.boolean())
    out.append(
        sel["MULT"] * (a_s * b_s - (hi_new - flag * two32) * two32 - res)
    )
    # msb ties: 2*(x - msb*2^31) must fit 32 bits
    msb_a_ops = sel_sum(["MULT", "SLT", "SLTI", "DIV"] + BRANCH_Z)
    msb_b_ops = sel_sum(["MULT", "SLT", "SRA", "SRAV", "DIV"])
    out.append(msb_a * (msb_a - one))
    out.append(msb_b * (msb_b - one))
    out.append(
        msb_a_ops * (bytes_sum(L.auxb_b) - E.Literal(2) * (rsv - msb_a * two31))
    )
    out.append(
        msb_b_ops * (bytes_sum(L.auxc_b) - E.Literal(2) * (rtv - msb_b * two31))
    )

    # DIVU: rs = q*rt + r with r < rt (q=lo_n=res bytes, r=hi_n=auxa bytes)
    cq, cr = _c(L.cq), _c(L.cr)
    out.append(cq.boolean())
    out.append(cr.boolean())
    out.append(sel["DIVU"] * (one - zf) * (rsv - lo_n * rtv - hi_n))
    out.append(sel["DIVU"] * (one - zf) * (bytes_sum(L.auxd_b) - (rtv - hi_n - one)))
    # DIV (signed, truncating): sa = sq*sb + sr, |sr| < |sb|,
    # sign(sr) = sign(sa) unless sr = 0. sq = lo_n - cq*2^32,
    # sr = hi_n - cr*2^32; uniqueness of (q, r) makes the pair sound.
    a_sg = rsv - msb_a * two32
    b_sg = rtv - msb_b * two32
    sq = lo_n - cq * two32
    sr = hi_n - cr * two32
    div_on = sel["DIV"] * (one - zf)
    out.append(div_on * (a_sg - sq * b_sg - sr))
    absr = sr * (one - E.Literal(2) * cr)
    absb = b_sg * (one - E.Literal(2) * msb_b)
    out.append(div_on * absr * (cr - msb_a))
    out.append(div_on * (bytes_sum(L.auxd_b) - (absb - absr - one)))
    # lo_n/hi_n byte-bounded on div rows via res_b (lo_n = res) and auxa

    # ALU
    out.append(sel_sum(["ADD", "ADDU"]) * (rsv + rtv - flag * two32 - res))
    out.append(sel_sum(["SUB", "SUBU"]) * (rsv - rtv + flag * two32 - res))
    out.append(addi * (rsv + imm - flag * two32 - res))
    out.append(sel["LUI"] * (imm * E.Literal(1 << 16) - res))
    out.append(sel_sum(COMPARES) * res.boolean())
    # comparisons: d = auxa bytes proves the claimed ordering
    d = bytes_sum(L.auxa_b)
    out.append(sel["SLTU"] * (d - (rsv - rtv + res * two32)))
    out.append(
        sel["SLT"]
        * (d - (rsv - rtv + E.Literal(2) * two31 * (msb_b - msb_a) + res * two32))
    )
    imm32 = _c(L.imm32)
    ineg = _c(L.ineg)
    out.append(ineg * (ineg - one))
    slti_ops = sel_sum(["SLTI", "SLTIU"])
    # imm32 = imm + ineg*2^32 (field identity; byte check pins the branch)
    out.append(slti_ops * (imm32 - imm - ineg * two32))
    out.append(slti_ops * (bytes_sum(L.auxd_b) - imm32))
    out.append(sel["SLTIU"] * (d - (rsv - imm32 + res * two32)))
    # SLTI: sign bit of imm32 is ineg by construction
    out.append(
        sel["SLTI"]
        * (d - (rsv - imm32 + E.Literal(2) * two31 * (ineg - msb_a) + res * two32))
    )
    out.append(sel["MFLO"] * (res - lo))
    out.append(sel["MFHI"] * (res - hi))
    link = sel["JAL"] + sel["JALR"] + sel["BLTZAL"] + sel["BGEZAL"]
    out.append(link * (res - npc - E.Literal(4)))
    out.append((sel["MOVZ"] + sel["MOVN"]) * (res - rsv))
    out.append(sel["SC"] * (res - one))

    # shifts: POW2 lookup pins (sa, pw, pw2b); flag < 2^sa via
    # flag < 2^32 (auxa) and flag*pw2b < 2^32 (auxb)
    pw, pw2b, sa_c, shq = _c(L.pw), _c(L.pw2b), _c(L.sa), _c(L.shq)
    sh_all = sel_sum(SHIFTS)
    out.append(sh_all * (bytes_sum(L.auxa_b) - flag))
    out.append(sh_all * (bytes_sum(L.auxb_b) - flag * pw2b))
    const_sh = sel_sum(CONST_SHIFTS)
    out.append(const_sh * (sa_c - imm))
    # variable shifts: sa = rsv mod 32 via quotient shq < 2^32
    var_sh = sel_sum(VAR_SHIFTS)
    out.append(var_sh * (rsv - E.Literal(32) * shq - sa_c))
    out.append(var_sh * (bytes_sum(L.auxd_b) - shq))
    out.append(sel_sum(["SLL", "SLLV"]) * (rtv * pw - flag * two32 - res))
    out.append(sel_sum(["SRL", "SRLV"]) * (res * pw + flag - rtv))
    out.append(
        sel_sum(["SRA", "SRAV"])
        * ((res - msb_b * two32) * pw + flag - (rtv - msb_b * two32))
    )

    # branch equality flag via inverse witness
    diff = rsv - rtv
    br = sel_sum(["BEQ", "BNE"])
    out.append(br * (diff * flag))
    out.append(br * (diff * inv - (one - flag)))
    # zero-relative branches: flag = taken, from msb_a (+ zf for BLEZ/BGTZ)
    out.append((sel["BLTZ"] + sel["BLTZAL"]) * (flag - msb_a))
    out.append((sel["BGEZ"] + sel["BGEZAL"]) * (flag - one + msb_a))
    out.append(sel["BLEZ"] * (flag - msb_a - zf))
    out.append(sel["BGTZ"] * (flag - one + msb_a + zf))

    # memory semantics (word-aligned Cannon model: EA = addr & ~3)
    maddr, mold, mval = _c(L.maddr), _c(L.mold), _c(L.mval)
    mlast, mcarry = _c(L.mlast), _c(L.mcarry)
    mq = _c(L.mq)
    moff = [_c(L.moff[k]) for k in range(4)]
    offv: E.Expr = E.Literal(0)
    for k in range(1, 4):
        offv = offv + E.Literal(k) * moff[k]
    sel_mem = sel_sum(MEM_OPS)
    sk_pre = sk["rpre"] + sk["wpre"]
    mem_all = sel_mem + sk_pre
    # byte-offset one-hot + aligned address with alignment witness
    for k in range(4):
        out.append(moff[k].boolean())
    out.append(moff[0] + moff[1] + moff[2] + moff[3] - mem_all)
    out.append(mem_all * (_c(L.auxa_b[0]) - E.Literal(4) * mq))
    out.append(sel_mem * mcarry * (mcarry - one) * (mcarry + one))
    out.append(sel_mem * (maddr + offv - rsv - imm + mcarry * two32))
    out.append(sk_pre * (maddr + offv - reg5))
    out.append(mem_all * (bytes_sum(L.auxa_b) - maddr))
    mem_acc = sel_mem + sk_pre * (one - noh[0])
    out.append(mem_acc * (bytes_sum(L.auxb_b) - (idx - mlast)))
    # reads leave the word unchanged
    reads = sel_sum(LOADS) + sk["wpre"]
    out.append(reads * (mold - mval))
    out.append((sel["LW"] + sel["LL"]) * (mval - res))
    out.append((sel["SW"] + sel["SC"]) * (mval - rtv))

    # big-endian byte views (mold for sub-word + preimage rows; rt for
    # merged stores/loads)
    mb = [_c(L.mold_b[k]) for k in range(4)]
    rtb = [_c(L.rt_b[k]) for k in range(4)]

    def be_sum(bs):
        s: E.Expr = E.Literal(0)
        for k, bexp in enumerate(bs):
            s = s + E.Literal(1 << (8 * (3 - k))) * bexp
        return s

    mb_gate = sel_sum(SUBWORD) + sk_pre
    out.append(mb_gate * (mold - be_sum(mb)))
    out.append(sel_sum(RT_BYTE_OPS) * (rtv - be_sum(rtb)))

    # sub-word loads: lbv = selected byte/halfword, sbit = its sign bit
    lbv, sbit = _c(L.lbv), _c(L.sbit)
    out.append(sbit.boolean())
    byte_sel: E.Expr = E.Literal(0)
    for k in range(4):
        byte_sel = byte_sel + moff[k] * mb[k]
    half_sel = (moff[0] + moff[1]) * (E.Literal(256) * mb[0] + mb[1]) + (
        moff[2] + moff[3]
    ) * (E.Literal(256) * mb[2] + mb[3])
    out.append((sel["LB"] + sel["LBU"]) * (lbv - byte_sel))
    out.append((sel["LH"] + sel["LHU"]) * (lbv - half_sel))
    out.append(sel["LBU"] * sbit)
    out.append(sel["LHU"] * sbit)
    out.append((sel["LB"] + sel["LBU"])
               * (_c(L.auxc_b[0]) - E.Literal(2) * (lbv - E.Literal(128) * sbit)))
    out.append((sel["LH"] + sel["LHU"])
               * (_c(L.auxc_b[0]) + E.Literal(256) * _c(L.auxc_b[1])
                  - E.Literal(2) * (lbv - E.Literal(1 << 15) * sbit)))
    out.append(sel["LBU"] * (res - lbv))
    out.append(sel["LB"] * (res - lbv - sbit * (two32 - E.Literal(1 << 8))))
    out.append(sel["LHU"] * (res - lbv))
    out.append(sel["LH"] * (res - lbv - sbit * (two32 - E.Literal(1 << 16))))

    # merged loads LWL/LWR: res bytes mix mold and rt bytes by offset
    lwl_res: E.Expr = E.Literal(0)
    lwr_res: E.Expr = E.Literal(0)
    for off in range(4):
        t_l: E.Expr = E.Literal(0)
        t_r: E.Expr = E.Literal(0)
        for k in range(4):
            w = E.Literal(1 << (8 * (3 - k)))
            t_l = t_l + w * (mb[k + off] if k + off <= 3 else rtb[k])
            t_r = t_r + w * (mb[k - 3 + off] if k >= 3 - off else rtb[k])
        lwl_res = lwl_res + moff[off] * t_l
        lwr_res = lwr_res + moff[off] * t_r
    out.append(sel["LWL"] * (res - lwl_res))
    out.append(sel["LWR"] * (res - lwr_res))

    # sub-word stores: mval bytes mix rt bytes into mold by offset
    sb_val: E.Expr = E.Literal(0)
    sh_val: E.Expr = E.Literal(0)
    swl_val: E.Expr = E.Literal(0)
    swr_val: E.Expr = E.Literal(0)
    for off in range(4):
        t_b: E.Expr = E.Literal(0)
        t_h: E.Expr = E.Literal(0)
        t_wl: E.Expr = E.Literal(0)
        t_wr: E.Expr = E.Literal(0)
        h = (off & 2) >> 1
        for k in range(4):
            w = E.Literal(1 << (8 * (3 - k)))
            t_b = t_b + w * (rtb[3] if k == off else mb[k])
            t_h = t_h + w * (rtb[2 + (k & 1)] if k >> 1 == h else mb[k])
            t_wl = t_wl + w * (rtb[k - off] if k >= off else mb[k])
            t_wr = t_wr + w * (rtb[k + 3 - off] if k <= off else mb[k])
        sb_val = sb_val + moff[off] * t_b
        sh_val = sh_val + moff[off] * t_h
        swl_val = swl_val + moff[off] * t_wl
        swr_val = swr_val + moff[off] * t_wr
    out.append(sel["SB"] * (mval - sb_val))
    out.append(sel["SH"] * (mval - sh_val))
    out.append(sel["SWL"] * (mval - swl_val))
    out.append(sel["SWR"] * (mval - swr_val))

    # bitwise decomposition ties
    sel_bw = sel_sum(BITWISE)
    sel_rbw = sel_sum(R_BITWISE)
    sel_ibw = sel_sum(I_BITWISE)
    out.append(sel_bw * (nib_sum(L.an) - rsv))
    out.append(sel_rbw * (nib_sum(L.bn) - rtv) + sel_ibw * (nib_sum(L.bn) - imm))
    out.append(sel_bw * (nib_sum(L.zn) - res))

    # program counter chain (Cannon delay-slot model; exit_group halts:
    # pc/npc are not advanced on the exit row)
    four = E.Literal(4)
    out.append((sel_any - sel["SYSCALL"]) * (pc_n - npc))
    out.append(sel["SYSCALL"] * ((one - sk["exit"]) * (pc_n - npc)
                                 + sk["exit"] * (pc_n - pc)))
    seq = sel_sum(
        [op for op in OPS
         if op not in ("J", "JAL", "JR", "JALR", "BEQ", "BNE", "SYSCALL")
         and op not in BRANCH_Z]
    )
    out.append(seq * (npc_n - npc - four))
    out.append(sel["SYSCALL"] * ((one - sk["exit"]) * (npc_n - npc - four)
                                 + sk["exit"] * (npc_n - npc)))
    # J/JAL: npc_n = (npc & 0xF0000000) | 4*target; npch = npc >> 28 is
    # pinned by decomposing npc's low 28 bits into auxe (top nibble
    # forced < 16 by auxf_b[0] = 16*auxe_b[3] being a byte)
    npch = _c(L.npch)
    jj = sel["J"] + sel["JAL"]
    npc_low = (_c(L.auxe_b[0]) + E.Literal(1 << 8) * _c(L.auxe_b[1])
               + E.Literal(1 << 16) * _c(L.auxe_b[2])
               + E.Literal(1 << 24) * _c(L.auxe_b[3]))
    out.append(jj * (npc - npch * E.Literal(1 << 28) - npc_low))
    out.append(jj * (_c(L.auxf_b[0]) - E.Literal(16) * _c(L.auxe_b[3])))
    out.append(jj * (npc_n - npch * E.Literal(1 << 28) - imm * four))
    out.append((sel["JR"] + sel["JALR"]) * (npc_n - rsv))
    out.append(sel["BEQ"] * (npc_n - npc - four - flag * (four * imm - four)))
    out.append(
        sel["BNE"] * (npc_n - npc - four - (one - flag) * (four * imm - four))
    )
    sel_bz = sel_sum(BRANCH_Z)
    out.append(sel_bz * (npc_n - npc - four - flag * (four * imm - four)))

    # ---- syscall structure -------------------------------------------
    sk_sum: E.Expr = E.Literal(0)
    for k in SYS_KINDS:
        out.append(sk[k].boolean())
        sk_sum = sk_sum + sk[k]
    out.append(sk_sum - sel["SYSCALL"])
    # kind -> syscall number (reg 2 on the row); "other" proves num is
    # none of the handled ones via two product-inverse witnesses
    kind_num = {
        "mmap0": SYS_MMAP, "mmap1": SYS_MMAP, "brk": SYS_BRK,
        "clone": SYS_CLONE, "exit": SYS_EXIT,
        "rpre": SYS_READ, "rhint": SYS_READ, "rstdin": SYS_READ,
        "rbad": SYS_READ,
        "wpre": SYS_WRITE, "whint": SYS_WRITE, "wout": SYS_WRITE,
        "wbad": SYS_WRITE,
        "fcr": SYS_FCNTL, "fcw": SYS_FCNTL, "fceinval": SYS_FCNTL,
        "fcbadf": SYS_FCNTL,
    }
    num_tie: E.Expr = E.Literal(0)
    for k, v in kind_num.items():
        num_tie = num_tie + sk[k] * (reg2 - E.Literal(v))
    out.append(num_tie)
    sinv, sinv2 = _c(L.sinv), _c(L.sinv2)
    p1: E.Expr = E.Literal(1)
    for s in (SYS_MMAP, SYS_BRK, SYS_CLONE, SYS_EXIT):
        p1 = p1 * (reg2 - E.Literal(s))
    p2: E.Expr = E.Literal(1)
    for s in (SYS_READ, SYS_WRITE, SYS_FCNTL):
        p2 = p2 * (reg2 - E.Literal(s))
    out.append(sk["other"] * (p1 * sinv - one))
    out.append(sk["other"] * (p2 * sinv2 - one))
    # fd / cmd disambiguation per kind (a0 = reg4, a1 = reg5)
    out.append(sk["mmap0"] * reg4)
    out.append(sk["mmap1"] * (reg4 * sinv - one))
    out.append(sk["rstdin"] * reg4)
    out.append(sk["rhint"] * (reg4 - E.Literal(FD_HINT_READ)))
    out.append(sk["rpre"] * (reg4 - E.Literal(FD_PRE_READ)))
    out.append(sk["rbad"] * (reg4 * (reg4 - E.Literal(3)) * (reg4 - E.Literal(5))
                             * sinv - one))
    out.append(sk["wout"] * (reg4 - one) * (reg4 - E.Literal(2)))
    out.append(sk["whint"] * (reg4 - E.Literal(FD_HINT_WRITE)))
    out.append(sk["wpre"] * (reg4 - E.Literal(FD_PRE_WRITE)))
    out.append(sk["wbad"] * ((reg4 - one) * (reg4 - E.Literal(2))
                             * (reg4 - E.Literal(4)) * (reg4 - E.Literal(6))
                             * sinv - one))
    out.append((sk["fcr"] + sk["fcw"] + sk["fcbadf"]) * (reg5 - E.Literal(3)))
    out.append(sk["fceinval"] * ((reg5 - E.Literal(3)) * sinv - one))
    out.append(sk["fcr"] * reg4 * (reg4 - E.Literal(3)) * (reg4 - E.Literal(5)))
    out.append(sk["fcw"] * (reg4 - one) * (reg4 - E.Literal(2))
               * (reg4 - E.Literal(4)) * (reg4 - E.Literal(6)))
    out.append(sk["fcbadf"] * (reg4 * (reg4 - one) * (reg4 - E.Literal(2))
                               * (reg4 - E.Literal(3)) * sinv - one))
    out.append(sk["fcbadf"] * ((reg4 - E.Literal(4)) * (reg4 - E.Literal(5))
                               * (reg4 - E.Literal(6)) * sinv2 - one))

    # mmap0: heap += align_up(size); alloc = 4096*m (m = auxe bytes),
    # alloc - size = pad12 in [0, 4096) via 16*pad12 being two bytes
    alloc = E.Literal(4096) * bytes_sum(L.auxe_b)
    pad12 = _c(L.pad12)
    out.append(sk["mmap0"] * (alloc - reg5 - pad12))
    out.append(sk["mmap0"] * (E.Literal(16) * pad12
                              - _c(L.auxf_b[0]) - E.Literal(256) * _c(L.auxf_b[1])))
    out.append(sk["mmap0"] * flag.boolean())
    out.append(sk["mmap0"] * (res - heap - alloc + flag * two32))

    # preimage read/write size: n = min(a2, 4 - off, [slen - po]) —
    # one-hot noh pins n in 0..4; byte checks prove each "<=", the
    # product proves n equals one of the bounds
    po, slen = _c(L.po), _c(L.slen)
    noh_sum: E.Expr = E.Literal(0)
    for m in range(5):
        out.append(noh[m].boolean())
        noh_sum = noh_sum + noh[m]
    out.append(noh_sum - sk_pre)
    out.append(sk_pre * (bytes_sum(L.auxc_b) - (reg6 - n_expr)))
    out.append(sk_pre * (_c(L.auxd_b[0]) - (four - offv - n_expr)))
    out.append(sk["rpre"] * (bytes_sum(L.auxe_b) - (slen - po - n_expr)))
    out.append(sk["rpre"] * (n_expr - reg6) * (n_expr - four + offv)
               * (n_expr - slen + po))
    out.append(sk["wpre"] * (n_expr - reg6) * (n_expr - four + offv))

    # rpre memory merge: bytes [off, off+n) of the word replaced by the
    # stream bytes sb[0..n)
    sbb = [_c(L.sb[k]) for k in range(4)]
    ind = []
    for i in range(4):
        s_i: E.Expr = E.Literal(0)
        for m in range(i + 1, 5):
            s_i = s_i + noh[m]
        ind.append(s_i)
    merged: E.Expr = E.Literal(0)
    for k in range(4):
        w_k: E.Expr = mb[k]
        for i in range(4):
            if 0 <= k - i <= 3:
                w_k = w_k + moff[k - i] * ind[i] * (sbb[i] - mb[k])
        merged = merged + E.Literal(1 << (8 * (3 - k))) * w_k
    out.append(sk["rpre"] * (mval - merged))

    # ---- machine-state propagation (heap, po, preimage key) ----------
    heap_n = _c(L.heap, E.NEXT)
    po_n = _c(L.po, E.NEXT)
    out.append(sel_any * (sk["mmap0"] * (heap_n - res)
                          + (one - sk["mmap0"]) * (heap_n - heap)))
    out.append(sel_any * (sk["rpre"] * (po_n - po - n_expr)
                          + sk["wpre"] * po_n
                          + (one - sk_pre) * (po_n - po)))
    # wpre shifts n data bytes (read from memory at [off, off+n)) into
    # the low end of the 32-byte key
    pk = [_c(L.pk_b[k]) for k in range(32)]
    pk_n = [_c(L.pk_b[k], E.NEXT) for k in range(32)]
    for i in range(32):
        shifted: E.Expr = E.Literal(0)
        for m in range(5):
            if i < 32 - m:
                shifted = shifted + noh[m] * pk[i + m]
            else:
                j = i - 32 + m  # j-th data byte = memory byte off+j
                data_j: E.Expr = E.Literal(0)
                for k in range(4):
                    if 0 <= k + j <= 3:
                        data_j = data_j + moff[k] * mb[k + j]
                shifted = shifted + noh[m] * data_j
        out.append(sel_any * (sk["wpre"] * (pk_n[i] - shifted)
                              + (one - sk["wpre"]) * (pk_n[i] - pk[i])))

    # boundary selectors live only on padding rows
    out.append(_c(L.isel) * (_c(L.isel) - one))
    out.append(_c(L.fsel) * (_c(L.fsel) - one))
    out.append(sel_any * _c(L.isel))
    out.append(sel_any * _c(L.fsel))

    # public statement boundaries
    init = init or {}
    pc0 = init.get("pc", 0)
    pk0 = init.get("pk", b"\x00" * 32)
    L0 = E.UnnormalizedLagrangeBasis(0)
    out.append(L0 * (pc - E.Literal(pc0 % p)))
    out.append(L0 * (npc - E.Literal((pc0 + 4) % p)))
    out.append(L0 * (idx - one))
    out.append(L0 * (hi - E.Literal(init.get("hi", 0) % p)))
    out.append(L0 * (lo - E.Literal(init.get("lo", 0) % p)))
    out.append(L0 * (heap - E.Literal(init.get("heap", 0) % p)))
    out.append(L0 * (po - E.Literal(init.get("po", 0) % p)))
    for k in range(32):
        out.append(L0 * (pk[k] - E.Literal(pk0[k])))
    regs0 = regs0 or [0] * 32
    for r in range(32):
        out.append(L0 * (_c(L.regs[r]) - E.Literal(regs0[r] % p)))
    if final_state is not None:
        Lk = E.UnnormalizedLagrangeBasis(k_steps)
        out.append(Lk * (pc - E.Literal(final_state["pc"] % p)))
        out.append(Lk * (hi - E.Literal(final_state["hi"] % p)))
        out.append(Lk * (lo - E.Literal(final_state["lo"] % p)))
        out.append(Lk * (heap - E.Literal(final_state.get("heap", 0) % p)))
        out.append(Lk * (po - E.Literal(final_state.get("po", 0) % p)))
        pkf = final_state.get("pk", b"\x00" * 32)
        for k in range(32):
            out.append(Lk * (pk[k] - E.Literal(pkf[k])))
        for r in range(32):
            out.append(Lk * (_c(L.regs[r]) - E.Literal(final_state["regs"][r] % p)))

    out.extend(logup.constraints())
    return out


# ---------------------------------------------------------------------------
# prove / verify
# ---------------------------------------------------------------------------


def _boundary_pin_columns(f: FieldParams, init_mem: dict, final_mem: dict,
                          last_access: dict, k_steps: int, n: int,
                          L: Layout | None = None):
    """The public boundary-record columns the verifier pins by
    recommitment: {col_index: full column}."""
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
    [op, rd, rs, rt, imm], int-keyed maps as sorted [key, value] pairs,
    bytes (the preimage keys and data, pk) as hex strings."""
    init, fin = statement["init"], statement["final"]

    def pairs(m: dict) -> list:
        return [[k, v] for k, v in sorted(m.items())]

    return {
        "program": [[i.op, i.rd, i.rs, i.rt, i.imm] for i in statement["program"]],
        "k_steps": statement["k_steps"],
        "regs0": list(statement["regs0"]),
        "init_memory": pairs(statement["init_memory"]),
        "bitwise_bits": statement["bitwise_bits"],
        "init": {**init, "pk": init["pk"].hex()},
        "preimages": [[k.hex(), v.hex()] for k, v in sorted(statement["preimages"].items())],
        "final": {"regs": list(fin["regs"]), "pc": fin["pc"], "hi": fin["hi"], "lo": fin["lo"],
                  "memory": pairs(fin["memory"]), "last_access": pairs(fin["last_access"]),
                  "heap": fin["heap"], "po": fin["po"], "pk": fin["pk"].hex(),
                  "exited": fin["exited"], "exit_code": fin["exit_code"]},
    }


def statement_from_json(data: dict) -> dict:
    """statement_to_json's data -> the statement verify_execution takes."""
    init, fin = data["init"], data["final"]
    return {
        "program": [Instr(*row) for row in data["program"]],
        "k_steps": data["k_steps"],
        "regs0": list(data["regs0"]),
        "init_memory": {a: v for a, v in data["init_memory"]},
        "bitwise_bits": data["bitwise_bits"],
        "init": {**init, "pk": bytes.fromhex(init["pk"])},
        "preimages": {bytes.fromhex(k): bytes.fromhex(v) for k, v in data["preimages"]},
        "final": {"regs": list(fin["regs"]), "pc": fin["pc"], "hi": fin["hi"], "lo": fin["lo"],
                  "memory": {a: v for a, v in fin["memory"]},
                  "last_access": {a: t for a, t in fin["last_access"]},
                  "heap": fin["heap"], "po": fin["po"], "pk": bytes.fromhex(fin["pk"]),
                  "exited": fin["exited"], "exit_code": fin["exit_code"]},
    }


def prove_execution(domain, srs, curve, program: list[Instr], n: int, rng,
                    regs0=None, memory=None, max_steps=None,
                    L: Layout | None = None, *, pc0: int = 0, hi0: int = 0,
                    lo0: int = 0, heap0: int = 0, po0: int = 0,
                    pk0: bytes = b"\x00" * 32,
                    preimages: dict | None = None, device=None):
    """Execute + prove, on `device` (the card unless the caller passes
    device="cpu"), where `domain` and `srs` live too. Returns
    (proof, statement); the statement is the public data (program, steps,
    initial and final machine state, and the preimage oracle contents)
    that verify_execution checks the proof against."""
    from ..ops import limb
    from .pickles import prove_columns

    dev = resolve_device(device)
    L = L or LAYOUT
    f = curve.scalar
    rows, state = execute(program, max_steps or (n // 2), regs0, memory,
                          pc0=pc0, hi0=hi0, lo0=lo0, heap0=heap0, po0=po0,
                          pk0=pk0, preimages=preimages)
    cols = build_columns(f, rows, state, n, L)
    logup = make_logup(f, program, n, L, preimages=preimages, pc0=pc0)
    full = logup.phase1_columns(cols)
    init = {"pc": pc0, "hi": hi0, "lo": lo0, "heap": heap0, "po": po0,
            "pk": pk0}
    cons = constraints(
        f, logup, len(rows), regs0, state, domain.d1.group_gen, L, init
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
        "init": init,
        "preimages": dict(preimages or {}),
        "final": {
            "regs": list(state["regs"]), "pc": state["pc"], "hi": state["hi"],
            "lo": state["lo"], "memory": dict(state["memory"]),
            "last_access": dict(state["last_access"]),
            "heap": state["heap"], "po": state["po"], "pk": state["pk"],
            "exited": state["exited"], "exit_code": state["exit_code"],
        },
    }
    return proof, statement


def verify_execution(domain, srs, curve, proof, statement, rng, device=None) -> bool:
    """Check the proof against the PUBLIC statement: rebuild the
    constraint system (ROM table from the program, boundary rows from
    the public memory images), pin the fixed tables and the seven
    boundary-record columns by recommitment, then run the column
    verifier. On `device`, the SRS's (the card unless the caller passes
    device="cpu")."""
    from .pickles import pinned_columns_match, verify_columns

    dev = resolve_device(device)
    if torch.device(srs.device).type != dev.type:
        raise ValueError(f"the SRS is on {srs.device}, expected {dev}")
    f = curve.scalar
    n = domain.d1.n
    L = Layout(statement.get("bitwise_bits", 4))
    init = statement.get("init", {})
    logup = make_logup(f, statement["program"], n, L,
                       preimages=statement.get("preimages"),
                       pc0=init.get("pc", 0))
    cons = constraints(
        f, logup, statement["k_steps"], statement["regs0"], statement["final"],
        domain.d1.group_gen, L, init,
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
