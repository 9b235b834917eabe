"""Minimal ELF32 loader for zkVM guest programs.

Counterpart of proof_systems_tpu/o1vm/elf.py, host code copied as it is.

Capability mirror of o1vm's program loading (o1vm/src/elf_loader.rs:
parse an ELF binary, map loadable segments, find the entry point;
little-endian for RISC-V 32, big-endian for MIPS, elf_loader.rs:149-166).
Pure-python struct parsing — no external dependencies.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

EM_RISCV = 243
EM_MIPS = 8
PT_LOAD = 1


@dataclass
class Segment:
    vaddr: int
    data: bytes
    flags: int  # PF_X=1, PF_W=2, PF_R=4


@dataclass
class Program:
    entry: int
    machine: int
    segments: list[Segment]
    endian: str = "little"  # instruction/word byte order

    def memory_image(self) -> dict[int, int]:
        """Word-addressed (4-byte) initial memory in the file's endianness."""
        mem: dict[int, int] = {}
        for seg in self.segments:
            data = seg.data
            for off in range(0, len(data), 4):
                word = int.from_bytes(data[off : off + 4].ljust(4, b"\0"), self.endian)
                mem[seg.vaddr + off] = word
        return mem

    def text_words(self) -> list[int]:
        """Instruction words of the executable segment, entry-first."""
        for seg in self.segments:
            if seg.flags & 1:
                off = self.entry - seg.vaddr
                data = seg.data[off:] if 0 <= off < len(seg.data) else seg.data
                return [
                    int.from_bytes(data[i : i + 4], self.endian)
                    for i in range(0, len(data) - len(data) % 4, 4)
                ]
        raise ValueError("no executable segment")


def load_elf(blob: bytes) -> Program:
    """Parse a 32-bit ELF executable (LE for RISC-V, BE for MIPS)."""
    if blob[:4] != b"\x7fELF":
        raise ValueError("not an ELF file")
    ei_class, ei_data = blob[4], blob[5]
    if ei_class != 1:
        raise ValueError("only ELF32 is supported")
    if ei_data not in (1, 2):
        raise ValueError(f"bad EI_DATA {ei_data}")
    endian = "little" if ei_data == 1 else "big"
    pfx = "<" if ei_data == 1 else ">"
    (e_type, e_machine, _ver, e_entry, e_phoff, _shoff, _flags,
     _ehsize, e_phentsize, e_phnum) = struct.unpack_from(pfx + "HHIIIIIHHH", blob, 16)
    segments = []
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        (p_type, p_offset, p_vaddr, _paddr, p_filesz, p_memsz, p_flags,
         _align) = struct.unpack_from(pfx + "IIIIIIII", blob, off)
        if p_type != PT_LOAD:
            continue
        data = blob[p_offset : p_offset + p_filesz]
        if p_memsz > p_filesz:
            data = data + b"\0" * (p_memsz - p_filesz)  # .bss
        segments.append(Segment(vaddr=p_vaddr, data=data, flags=p_flags))
    return Program(entry=e_entry, machine=e_machine, segments=segments, endian=endian)


def build_elf(machine: int, entry: int, text: bytes, data: tuple[int, bytes] | None = None,
              endian: str = "little") -> bytes:
    """Assemble a minimal ELF32 executable (testing + tooling)."""
    phnum = 2 if data else 1
    ehsize, phentsize = 52, 32
    text_off = ehsize + phnum * phentsize
    pfx = "<" if endian == "little" else ">"
    blob = bytearray()
    blob += b"\x7fELF" + bytes([1, 1 if endian == "little" else 2, 1, 0]) + b"\0" * 8
    blob += struct.pack(
        pfx + "HHIIIIIHHHHHH", 2, machine, 1, entry, ehsize, 0, 0,
        ehsize, phentsize, phnum, 0, 0, 0,
    )
    blob += struct.pack(pfx + "IIIIIIII", PT_LOAD, text_off, entry, entry,
                        len(text), len(text), 5, 4)
    if data:
        data_off = text_off + len(text)
        blob += struct.pack(pfx + "IIIIIIII", PT_LOAD, data_off, data[0], data[0],
                            len(data[1]), len(data[1]), 6, 4)
    blob += text
    if data:
        blob += data[1]
    return bytes(blob)
