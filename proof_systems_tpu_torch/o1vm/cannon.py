"""Optimism Cannon compatibility layer: state snapshots, page-mapped
memory, the preimage-oracle channel, and a full-ISA MIPS witness runner.

Counterpart of proof_systems_tpu/o1vm/cannon.py, host code copied as it is
but for PreImageOracle.start, which hands the host program its channels on
fds 3-6 for real (the JAX package's closes them before the exec).

Reference surfaces reproduced here:
  - `o1vm/src/cannon.rs` — `State`/`Page` state.json format (zlib+base64
    4 KiB pages, 0x-hex preimage key), `StepFrequency`, `Meta` symbol
    maps, the host-program description (cannon.rs:52-130,146-204,263).
  - `o1vm/src/preimage_oracle.rs` — the bidirectional pipe protocol to
    an op-program host: 32-byte key -> u64-BE length || data; hints as
    u64-BE length || hint -> 1-byte ack (preimage_oracle.rs:170-235).
  - `o1vm/src/interpreters/mips/witness.rs` — witness-mode execution of
    the FULL MIPS ISA including the Cannon syscall surface (mmap/brk/
    clone/exit_group/read/write/fcntl, interpreter.rs:1148-1463) and the
    preimage read/write/hint semantics (witness.rs:696-830).

The provable window stays in mips.py (constraint-backed subset with the
LogUp soundness argument); `CannonVM` is the witness-generation layer
that can run arbitrary Cannon snapshots, mirroring how the reference
splits witness mode from constraint mode.
"""

from __future__ import annotations

import base64
import fcntl
import json
import os
import signal
import zlib
from dataclasses import dataclass, field

PAGE_ADDRESS_SIZE = 12
PAGE_SIZE = 1 << PAGE_ADDRESS_SIZE
PAGE_ADDRESS_MASK = PAGE_SIZE - 1

# fd numbers of the Cannon client channels (cannon.rs:314-317)
FD_STDIN, FD_STDOUT, FD_STDERR = 0, 1, 2
FD_HINT_READ, FD_HINT_WRITE = 3, 4
FD_PREIMAGE_READ, FD_PREIMAGE_WRITE = 5, 6

SYSCALL_MMAP = 4090
SYSCALL_BRK = 4045
SYSCALL_CLONE = 4120
SYSCALL_EXIT_GROUP = 4246
SYSCALL_READ = 4003
SYSCALL_WRITE = 4004
SYSCALL_FCNTL = 4055

TWO32 = 1 << 32


# ---------------------------------------------------------------------------
# state.json codec (cannon.rs:19-75)
# ---------------------------------------------------------------------------


def _decode_page(b64: str) -> bytes:
    data = zlib.decompress(base64.standard_b64decode(b64))
    if len(data) != PAGE_SIZE:
        raise ValueError(f"page is {len(data)} bytes, want {PAGE_SIZE}")
    return data


def _encode_page(data: bytes) -> str:
    return base64.standard_b64encode(zlib.compress(bytes(data))).decode()


def parse_preimage_key(s: str) -> bytes:
    """'0x' + 64 hex chars (or bare 64 hex) -> 32 bytes (cannon.rs:86-125)."""
    hexpart = s.split("x")[-1]
    if len(hexpart) != 64:
        raise ValueError(f"{s} is not 32-bytes long")
    return bytes.fromhex(hexpart)


@dataclass
class State:
    """Cannon VM snapshot (cannon.rs:52-75). Field names in the JSON
    match OP Cannon's renames (preimageKey/preimageOffset/nextPC)."""

    memory: dict[int, bytearray]  # page index -> PAGE_SIZE bytes
    preimage_key: bytes = b"\x00" * 32
    preimage_offset: int = 0
    pc: int = 0
    next_pc: int = 4
    lo: int = 0
    hi: int = 0
    heap: int = 0
    exit: int = 0
    exited: bool = False
    step: int = 0
    registers: list[int] = field(default_factory=lambda: [0] * 32)
    last_hint: bytes | None = None
    preimage: bytes | None = None

    @classmethod
    def from_json(cls, obj: dict) -> "State":
        mem = {}
        for page in obj["memory"]:
            mem[int(page["index"])] = bytearray(_decode_page(page["data"]))
        lh = obj.get("last_hint")
        pre = obj.get("preimage")
        return cls(
            memory=mem,
            preimage_key=parse_preimage_key(obj["preimageKey"]),
            preimage_offset=int(obj["preimageOffset"]),
            pc=int(obj["pc"]),
            next_pc=int(obj["nextPC"]),
            lo=int(obj["lo"]),
            hi=int(obj["hi"]),
            heap=int(obj["heap"]),
            exit=int(obj["exit"]),
            exited=bool(obj["exited"]),
            step=int(obj["step"]),
            registers=[int(r) for r in obj["registers"]],
            last_hint=bytes(lh) if lh is not None else None,
            preimage=bytes(pre) if pre is not None else None,
        )

    @classmethod
    def load(cls, path: str) -> "State":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def to_json(self) -> dict:
        return {
            "memory": [
                {"index": idx, "data": _encode_page(self.memory[idx])}
                for idx in sorted(self.memory)
            ],
            "preimageKey": "0x" + self.preimage_key.hex(),
            "preimageOffset": self.preimage_offset,
            "pc": self.pc,
            "nextPC": self.next_pc,
            "lo": self.lo,
            "hi": self.hi,
            "heap": self.heap,
            "exit": self.exit,
            "exited": self.exited,
            "step": self.step,
            "registers": list(self.registers),
            "last_hint": list(self.last_hint) if self.last_hint is not None else None,
            "preimage": list(self.preimage) if self.preimage is not None else None,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


# ---------------------------------------------------------------------------
# StepFrequency (cannon.rs:146-204)
# ---------------------------------------------------------------------------


class StepFrequency:
    """never | always | =n | %n | n..[m]"""

    def __init__(self, kind: str, a: int = 0, b: int | None = None):
        self.kind = kind
        self.a = a
        self.b = b

    @classmethod
    def parse(cls, s: str) -> "StepFrequency":
        if s == "never":
            return cls("never")
        if s == "always":
            return cls("always")
        if s.startswith("%"):
            return cls("every", int(s[1:]))
        if s.startswith("="):
            return cls("exactly", int(s[1:]))
        if ".." in s:
            lo, _, hi = s.partition("..")
            return cls("range", int(lo), int(hi) if hi else None)
        raise ValueError(f"Unknown frequency format {s}")

    def matches(self, step: int) -> bool:
        if self.kind == "never":
            return False
        if self.kind == "always":
            return True
        if self.kind == "exactly":
            return step == self.a
        if self.kind == "every":
            return self.a > 0 and step % self.a == 0
        return step >= self.a and (self.b is None or step < self.b)


@dataclass
class Meta:
    """Symbol table sidecar (cannon.rs:263-310); symbols sorted by start."""

    symbols: list[tuple[str, int, int]]  # (name, start, size)

    @classmethod
    def load(cls, path: str) -> "Meta":
        with open(path) as f:
            obj = json.load(f)
        syms = [(s["name"], int(s["start"]), int(s["size"])) for s in obj["symbols"]]
        syms.sort(key=lambda s: s[1])
        return cls(syms)

    def find_address_symbol(self, address: int) -> str | None:
        lo, hi = 0, len(self.symbols)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.symbols[mid][1] <= address:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0:
            return None
        name, start, size = self.symbols[lo - 1]
        return name if start <= address < start + size else None


# ---------------------------------------------------------------------------
# Page-mapped memory
# ---------------------------------------------------------------------------


class PagedMemory:
    """Big-endian word access over Cannon's 4 KiB page map."""

    def __init__(self, pages: dict[int, bytearray]):
        self.pages = pages

    def _page(self, index: int) -> bytearray:
        page = self.pages.get(index)
        if page is None:
            page = bytearray(PAGE_SIZE)
            self.pages[index] = page
        return page

    def read_byte(self, addr: int) -> int:
        addr &= 0xFFFFFFFF
        return self._page(addr >> PAGE_ADDRESS_SIZE)[addr & PAGE_ADDRESS_MASK]

    def write_byte(self, addr: int, value: int) -> None:
        addr &= 0xFFFFFFFF
        self._page(addr >> PAGE_ADDRESS_SIZE)[addr & PAGE_ADDRESS_MASK] = value & 0xFF

    def read_word(self, addr: int) -> int:
        """Aligned 32-bit BE read at addr & ~3."""
        addr &= 0xFFFFFFFC
        page = self._page(addr >> PAGE_ADDRESS_SIZE)
        off = addr & PAGE_ADDRESS_MASK
        return int.from_bytes(page[off : off + 4], "big")

    def write_word(self, addr: int, value: int) -> None:
        addr &= 0xFFFFFFFC
        page = self._page(addr >> PAGE_ADDRESS_SIZE)
        off = addr & PAGE_ADDRESS_MASK
        page[off : off + 4] = (value & 0xFFFFFFFF).to_bytes(4, "big")

    def word_dict(self) -> dict[int, int]:
        """All nonzero words as {word_address//4: value} — the format
        mips.py's RAM argument consumes."""
        out = {}
        for idx, page in self.pages.items():
            base = idx << PAGE_ADDRESS_SIZE
            for off in range(0, PAGE_SIZE, 4):
                w = int.from_bytes(page[off : off + 4], "big")
                if w:
                    out[(base + off) >> 2] = w
        return out


def state_from_elf(blob: bytes) -> State:
    """Build an initial Cannon State from an ELF32 executable
    (o1vm/src/elf_loader.rs make_state: map loadable segments into
    pages, pc = e_entry, everything else zeroed)."""
    from .elf import load_elf

    program = load_elf(blob)
    st = State(memory={})
    mem = PagedMemory(st.memory)
    for seg in program.segments:
        for i, byte in enumerate(seg.data):
            if byte:
                mem.write_byte(seg.vaddr + i, byte)
    if program.entry == 0:
        raise ValueError("ELF has no entry point (object file, not executable?)")
    st.pc = program.entry
    st.next_pc = program.entry + 4
    return st


# ---------------------------------------------------------------------------
# Preimage oracles (preimage_oracle.rs)
# ---------------------------------------------------------------------------


class NullPreImageOracle:
    def get_preimage(self, key: bytes) -> bytes:
        raise RuntimeError("No preimage oracle specified for preimage retrieval")

    def hint(self, hint: bytes) -> None:
        raise RuntimeError("No preimage oracle specified for hints")


class InMemoryPreImageOracle:
    """Dict-backed oracle for tests and self-contained fixtures."""

    def __init__(self, preimages: dict[bytes, bytes]):
        self.preimages = dict(preimages)
        self.hints: list[bytes] = []

    def get_preimage(self, key: bytes) -> bytes:
        return self.preimages[bytes(key)]

    def hint(self, hint: bytes) -> None:
        self.hints.append(bytes(hint))


class PreImageOracle:
    """Pipes to an op-program host process (preimage_oracle.rs:108-235).

    The child sees the hint channel on fds 3 (read) / 4 (write) and the
    preimage channel on fds 5 / 6, exactly as Cannon hosts expect."""

    def __init__(self, name: str, arguments: list[str]):
        self.cmd = [name, *arguments]
        self.pid: int | None = None

    def start(self) -> None:
        # two bidirectional channels: (our write -> child read) and
        # (child write -> our read), for hints and preimages
        h_req_r, h_req_w = os.pipe()  # we write hints, child reads on 3
        h_resp_r, h_resp_w = os.pipe()  # child acks on 4, we read
        p_req_r, p_req_w = os.pipe()  # we write keys, child reads on 5
        p_resp_r, p_resp_w = os.pipe()  # child answers on 6, we read
        child_ends = {3: h_req_r, 4: h_resp_w, 5: p_req_r, 6: p_resp_w}
        # Each child-side end is copied above 10 first (close-on-exec, as
        # every pipe end here is), so that no dup2 onto 3-6 lands on an end
        # not yet placed and none is a no-op dup2 that would keep its
        # close-on-exec flag. posix_spawn's dup2 actions then give the child
        # exactly fds 3-6, inheritable; the parent's ends close at its exec.
        high = {t: fcntl.fcntl(src, fcntl.F_DUPFD_CLOEXEC, 10) for t, src in child_ends.items()}
        for fd in child_ends.values():
            os.close(fd)
        try:
            self.pid = os.posix_spawnp(
                self.cmd[0], self.cmd, os.environ,
                file_actions=[(os.POSIX_SPAWN_DUP2, src, t) for t, src in high.items()],
            )
        except BaseException:
            for fd in (h_req_w, h_resp_r, p_req_w, p_resp_r):
                os.close(fd)
            raise
        finally:
            for fd in high.values():
                os.close(fd)
        self._hint_w = os.fdopen(h_req_w, "wb", buffering=0)
        self._hint_r = os.fdopen(h_resp_r, "rb", buffering=0)
        self._pre_w = os.fdopen(p_req_w, "wb", buffering=0)
        self._pre_r = os.fdopen(p_resp_r, "rb", buffering=0)

    def _read_exact(self, f, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = f.read(n - len(buf))
            if not chunk:
                raise EOFError("oracle channel closed")
            buf += chunk
        return buf

    def get_preimage(self, key: bytes) -> bytes:
        self._pre_w.write(bytes(key))
        length = int.from_bytes(self._read_exact(self._pre_r, 8), "big")
        return self._read_exact(self._pre_r, length)

    def hint(self, hint: bytes) -> None:
        self._hint_w.write(len(hint).to_bytes(8, "big") + bytes(hint))
        self._read_exact(self._hint_r, 1)

    def close(self) -> None:
        if self.pid is not None:
            for f in (self._hint_w, self._hint_r, self._pre_w, self._pre_r):
                f.close()
            os.kill(self.pid, signal.SIGTERM)
            os.waitpid(self.pid, 0)
            self.pid = None


# ---------------------------------------------------------------------------
# Full-ISA witness runner (interpreters/mips/witness.rs equivalent)
# ---------------------------------------------------------------------------


def _se(v: int, bits: int) -> int:
    return (v & ((1 << bits) - 1)) - ((v & (1 << (bits - 1))) << 1)


class CannonVM:
    """Step a Cannon State through the full MIPS ISA with syscall and
    preimage-oracle support. Mutates `state` in place."""

    def __init__(self, state: State, oracle=None, meta: Meta | None = None):
        self.state = state
        self.mem = PagedMemory(state.memory)
        self.oracle = oracle or NullPreImageOracle()
        self.meta = meta

    # -- syscall helpers ----------------------------------------------------

    def _preimage_stream(self) -> bytes:
        st = self.state
        if st.preimage is None or st.preimage_offset == 0:
            st.preimage = self.oracle.get_preimage(st.preimage_key)
        return len(st.preimage).to_bytes(8, "big") + st.preimage

    def _sys_read(self, regs) -> tuple[int, int]:
        fd, addr, count = regs[4], regs[5], regs[6]
        if fd == FD_STDIN:
            return 0, 0
        if fd == FD_HINT_READ:
            return count, 0
        if fd == FD_PREIMAGE_READ:
            dat = self._preimage_stream()
            n = min(count, 4 - (addr & 3), len(dat) - self.state.preimage_offset)
            n = max(n, 0)
            for i in range(n):
                self.mem.write_byte(addr + i, dat[self.state.preimage_offset + i])
            self.state.preimage_offset += n
            return n, 0
        return 0xFFFFFFFF, 0x9  # EBADF

    def _sys_write(self, regs) -> tuple[int, int]:
        fd, addr, count = regs[4], regs[5], regs[6]
        if fd in (FD_STDOUT, FD_STDERR):
            return count, 0
        if fd == FD_HINT_WRITE:
            buf = bytearray(self.state.last_hint or b"")
            for i in range(count):
                buf.append(self.mem.read_byte(addr + i))
            # flush complete u32-BE length-prefixed hints (witness.rs:360-377)
            idx = 0
            while idx + 4 <= len(buf):
                hlen = int.from_bytes(buf[idx : idx + 4], "big")
                if idx + 4 + hlen > len(buf):
                    break
                self.oracle.hint(bytes(buf[idx + 4 : idx + 4 + hlen]))
                idx += 4 + hlen
            self.state.last_hint = bytes(buf[idx:])
            return count, 0
        if fd == FD_PREIMAGE_WRITE:
            n = min(count, 4 - (addr & 3))
            dat = bytes(self.mem.read_byte(addr + i) for i in range(n))
            self.state.preimage_key = self.state.preimage_key[n:] + dat
            self.state.preimage_offset = 0
            self.state.preimage = None
            return n, 0
        return 0xFFFFFFFF, 0x9  # EBADF

    def _sys_fcntl(self, regs) -> tuple[int, int]:
        fd, cmd = regs[4], regs[5]
        if cmd != 3:  # != F_GETFL
            return 0xFFFFFFFF, 0x16  # EINVAL
        if fd in (FD_STDIN, FD_HINT_READ, FD_PREIMAGE_READ):
            return 0, 0
        if fd in (FD_STDOUT, FD_STDERR, FD_HINT_WRITE, FD_PREIMAGE_WRITE):
            return 1, 0
        return 0xFFFFFFFF, 0x9  # EBADF

    def _syscall(self, regs) -> None:
        st = self.state
        num = regs[2]
        v0 = v1 = 0
        if num == SYSCALL_MMAP:
            size = regs[5]
            pages = (size + PAGE_SIZE - 1) >> PAGE_ADDRESS_SIZE
            alloc = pages << PAGE_ADDRESS_SIZE
            if regs[4] == 0:
                v0 = st.heap
                st.heap = (st.heap + alloc) % TWO32
            else:
                v0 = regs[4]
        elif num == SYSCALL_EXIT_GROUP:
            st.exit = regs[4] & 0xFF
            st.exited = True
            return
        elif num == SYSCALL_READ:
            v0, v1 = self._sys_read(regs)
        elif num == SYSCALL_WRITE:
            v0, v1 = self._sys_write(regs)
        elif num == SYSCALL_FCNTL:
            v0, v1 = self._sys_fcntl(regs)
        elif num == SYSCALL_BRK:
            v0 = 0x40000000
        elif num == SYSCALL_CLONE:
            v0 = 1
        # other syscalls: v0 = v1 = 0 (interpreter.rs:1454-1463)
        regs[2] = v0 & 0xFFFFFFFF
        regs[7] = v1

    # -- the step -----------------------------------------------------------

    def step(self) -> None:
        """Execute one instruction (Cannon pc/next_pc delay-slot model)."""
        st = self.state
        if st.exited:
            return
        regs = st.registers
        pc, npc = st.pc, st.next_pc
        word = self.mem.read_word(pc)
        st.step += 1

        opcode = (word >> 26) & 0x3F
        rs_i = (word >> 21) & 31
        rt_i = (word >> 16) & 31
        rd_i = (word >> 11) & 31
        sa = (word >> 6) & 31
        funct = word & 0x3F
        imm16 = word & 0xFFFF
        simm = _se(imm16, 16)
        target = word & 0x3FFFFFF
        rs = regs[rs_i]
        rt = regs[rt_i]

        new_npc = (npc + 4) % TWO32
        wreg: int | None = None
        res = 0

        def branch(cond: bool) -> None:
            nonlocal new_npc
            if cond:
                new_npc = (npc + (simm << 2)) % TWO32

        if opcode == 0:
            if funct == 0x00:  # SLL
                wreg, res = rd_i, (rt << sa) % TWO32
            elif funct == 0x02:  # SRL
                wreg, res = rd_i, rt >> sa
            elif funct == 0x03:  # SRA
                wreg, res = rd_i, (_se(rt, 32) >> sa) % TWO32
            elif funct == 0x04:  # SLLV
                wreg, res = rd_i, (rt << (rs & 31)) % TWO32
            elif funct == 0x06:  # SRLV
                wreg, res = rd_i, rt >> (rs & 31)
            elif funct == 0x07:  # SRAV
                wreg, res = rd_i, (_se(rt, 32) >> (rs & 31)) % TWO32
            elif funct == 0x08:  # JR
                new_npc = rs
            elif funct == 0x09:  # JALR
                wreg, res = rd_i, (npc + 4) % TWO32
                new_npc = rs
            elif funct == 0x0A:  # MOVZ
                if rt == 0:
                    wreg, res = rd_i, rs
            elif funct == 0x0B:  # MOVN
                if rt != 0:
                    wreg, res = rd_i, rs
            elif funct == 0x0C:  # SYSCALL
                self._syscall(regs)
                if st.exited:
                    return
            elif funct == 0x0F:  # SYNC
                pass
            elif funct == 0x10:  # MFHI
                wreg, res = rd_i, st.hi
            elif funct == 0x11:  # MTHI
                st.hi = rs
            elif funct == 0x12:  # MFLO
                wreg, res = rd_i, st.lo
            elif funct == 0x13:  # MTLO
                st.lo = rs
            elif funct in (0x18, 0x19):  # MULT/MULTU
                a = _se(rs, 32) if funct == 0x18 else rs
                b = _se(rt, 32) if funct == 0x18 else rt
                prod = (a * b) % (1 << 64)
                st.lo, st.hi = prod & 0xFFFFFFFF, prod >> 32
            elif funct in (0x1A, 0x1B):  # DIV/DIVU
                if funct == 0x1A:
                    a, b = _se(rs, 32), _se(rt, 32)
                    if b != 0:
                        q = abs(a) // abs(b)
                        if (a < 0) != (b < 0):
                            q = -q
                        st.lo, st.hi = q % TWO32, (a - b * q) % TWO32
                else:
                    if rt != 0:
                        st.lo, st.hi = rs // rt, rs % rt
            elif funct == 0x20:  # ADD
                wreg, res = rd_i, (rs + rt) % TWO32
            elif funct == 0x21:  # ADDU
                wreg, res = rd_i, (rs + rt) % TWO32
            elif funct == 0x22:  # SUB
                wreg, res = rd_i, (rs - rt) % TWO32
            elif funct == 0x23:  # SUBU
                wreg, res = rd_i, (rs - rt) % TWO32
            elif funct == 0x24:  # AND
                wreg, res = rd_i, rs & rt
            elif funct == 0x25:  # OR
                wreg, res = rd_i, rs | rt
            elif funct == 0x26:  # XOR
                wreg, res = rd_i, rs ^ rt
            elif funct == 0x27:  # NOR
                wreg, res = rd_i, (~(rs | rt)) % TWO32
            elif funct == 0x2A:  # SLT
                wreg, res = rd_i, int(_se(rs, 32) < _se(rt, 32))
            elif funct == 0x2B:  # SLTU
                wreg, res = rd_i, int(rs < rt)
            else:
                raise ValueError(f"unsupported R funct {funct:#x} at pc={pc:#x}")
        elif opcode == 0x01:  # REGIMM
            if rt_i == 0x00:  # BLTZ
                branch(_se(rs, 32) < 0)
            elif rt_i == 0x01:  # BGEZ
                branch(_se(rs, 32) >= 0)
            elif rt_i == 0x10:  # BLTZAL
                regs[31] = (npc + 4) % TWO32
                branch(_se(rs, 32) < 0)
            elif rt_i == 0x11:  # BGEZAL
                regs[31] = (npc + 4) % TWO32
                branch(_se(rs, 32) >= 0)
            else:
                raise ValueError(f"unsupported regimm rt {rt_i:#x} at pc={pc:#x}")
        elif opcode == 0x02:  # J
            new_npc = ((npc & 0xF0000000) | (target << 2)) % TWO32
        elif opcode == 0x03:  # JAL
            regs[31] = (npc + 4) % TWO32
            new_npc = ((npc & 0xF0000000) | (target << 2)) % TWO32
        elif opcode == 0x04:  # BEQ
            branch(rs == rt)
        elif opcode == 0x05:  # BNE
            branch(rs != rt)
        elif opcode == 0x06:  # BLEZ
            branch(_se(rs, 32) <= 0)
        elif opcode == 0x07:  # BGTZ
            branch(_se(rs, 32) > 0)
        elif opcode == 0x08:  # ADDI
            wreg, res = rt_i, (rs + simm) % TWO32
        elif opcode == 0x09:  # ADDIU
            wreg, res = rt_i, (rs + simm) % TWO32
        elif opcode == 0x0A:  # SLTI
            wreg, res = rt_i, int(_se(rs, 32) < simm)
        elif opcode == 0x0B:  # SLTIU
            wreg, res = rt_i, int(rs < simm % TWO32)
        elif opcode == 0x0C:  # ANDI
            wreg, res = rt_i, rs & imm16
        elif opcode == 0x0D:  # ORI
            wreg, res = rt_i, rs | imm16
        elif opcode == 0x0E:  # XORI
            wreg, res = rt_i, rs ^ imm16
        elif opcode == 0x0F:  # LUI
            wreg, res = rt_i, (imm16 << 16) % TWO32
        elif opcode in (0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x30):  # loads
            addr = (rs + simm) % TWO32
            mem = self.mem.read_word(addr)
            n = addr & 3
            if opcode == 0x20:  # LB
                res = _se((mem >> (24 - n * 8)) & 0xFF, 8) % TWO32
            elif opcode == 0x21:  # LH
                res = _se((mem >> (16 - (addr & 2) * 8)) & 0xFFFF, 16) % TWO32
            elif opcode == 0x22:  # LWL (big-endian)
                val = (mem << (n * 8)) % TWO32
                mask = (0xFFFFFFFF << (n * 8)) % TWO32
                res = (rt & ~mask & 0xFFFFFFFF) | val
            elif opcode == 0x23:  # LW
                res = mem
            elif opcode == 0x24:  # LBU
                res = (mem >> (24 - n * 8)) & 0xFF
            elif opcode == 0x25:  # LHU
                res = (mem >> (16 - (addr & 2) * 8)) & 0xFFFF
            elif opcode == 0x26:  # LWR (big-endian)
                sh = 24 - n * 8
                val = mem >> sh
                mask = 0xFFFFFFFF >> sh
                res = (rt & ~mask & 0xFFFFFFFF) | val
            elif opcode == 0x30:  # LL
                res = mem
            wreg = rt_i
        elif opcode in (0x28, 0x29, 0x2A, 0x2B, 0x2E, 0x38):  # stores
            addr = (rs + simm) % TWO32
            mem = self.mem.read_word(addr)
            n = addr & 3
            if opcode == 0x28:  # SB
                sh = 24 - n * 8
                mem = (mem & ~(0xFF << sh) & 0xFFFFFFFF) | ((rt & 0xFF) << sh)
            elif opcode == 0x29:  # SH
                sh = 16 - (addr & 2) * 8
                mem = (mem & ~(0xFFFF << sh) & 0xFFFFFFFF) | ((rt & 0xFFFF) << sh)
            elif opcode == 0x2A:  # SWL (big-endian)
                val = rt >> (n * 8)
                mask = 0xFFFFFFFF >> (n * 8)
                mem = (mem & ~mask & 0xFFFFFFFF) | val
            elif opcode == 0x2B:  # SW
                mem = rt
            elif opcode == 0x2E:  # SWR (big-endian)
                sh = 24 - n * 8
                val = (rt << sh) % TWO32
                mask = (0xFFFFFFFF << sh) % TWO32
                mem = (mem & ~mask & 0xFFFFFFFF) | val
            elif opcode == 0x38:  # SC
                mem = rt
                wreg, res = rt_i, 1
            self.mem.write_word(addr, mem)
        else:
            raise ValueError(f"unsupported opcode {opcode:#x} at pc={pc:#x}")

        if wreg is not None and wreg != 0:
            regs[wreg] = res % TWO32
        regs[0] = 0
        st.pc, st.next_pc = npc, new_npc

    def run(
        self,
        stop_at: StepFrequency | None = None,
        max_steps: int | None = None,
        info_at: StepFrequency | None = None,
        snapshot_at: StepFrequency | None = None,
        snapshot_fmt: str = "state-%d.json",
        halt_address: int | None = None,
    ) -> State:
        st = self.state
        steps = 0
        while not st.exited:
            if stop_at is not None and stop_at.matches(st.step):
                break
            if halt_address is not None and st.pc == halt_address:
                break
            if max_steps is not None and steps >= max_steps:
                break
            if info_at is not None and info_at.matches(st.step):
                sym = self.meta.find_address_symbol(st.pc) if self.meta else None
                print(f"step={st.step} pc={st.pc:#x} {sym or ''}")
            if snapshot_at is not None and snapshot_at.matches(st.step):
                st.save(snapshot_fmt.replace("%d", str(st.step)))
            self.step()
            steps += 1
        return st
