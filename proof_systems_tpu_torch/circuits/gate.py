"""Circuit gates: types, wires, and the 15-column register layout.

Reference semantics: kimchi/src/circuits/gate.rs:67-130 (GateType and
CircuitGate) and wires.rs:7-10 (COLUMNS = 15, PERMUTS = 7). The four
dead Cairo variants are kept so that serialized indices stay compatible
(CHANGELOG.md:44-47).

Counterpart of proof_systems_tpu/circuits/gate.py, host code copied as it is.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

COLUMNS = 15
PERMUTS = 7


class GateType(enum.IntEnum):
    Zero = 0
    Generic = 1
    Poseidon = 2
    CompleteAdd = 3
    VarBaseMul = 4
    EndoMul = 5
    EndoMulScalar = 6
    Lookup = 7
    # obsolete Cairo gates, kept for serialization compatibility
    CairoClaim = 8
    CairoInstruction = 9
    CairoFlags = 10
    CairoTransition = 11
    RangeCheck0 = 12
    RangeCheck1 = 13
    ForeignFieldAdd = 14
    ForeignFieldMul = 15
    Xor16 = 16
    Rot64 = 17


@dataclass(frozen=True)
class Wire:
    """A cell position (row, col) in the first PERMUTS columns."""

    row: int
    col: int


def new_wires(row: int) -> tuple[Wire, ...]:
    """Self-wired row (each permuted cell cycles to itself)."""
    return tuple(Wire(row, col) for col in range(PERMUTS))


@dataclass
class CircuitGate:
    typ: GateType
    wires: tuple[Wire, ...]  # PERMUTS entries
    coeffs: list[int] = field(default_factory=list)

    @classmethod
    def zero(cls, row: int) -> "CircuitGate":
        return cls(GateType.Zero, new_wires(row), [])


def connect_cell_pair(gates: list[CircuitGate], a: tuple[int, int], b: tuple[int, int]) -> None:
    """Swap wire targets to join two cells into one copy cycle
    (gate.rs CircuitGate::connect_cell_pair)."""
    (r1, c1), (r2, c2) = a, b
    w1 = gates[r1].wires[c1]
    w2 = gates[r2].wires[c2]
    ws1 = list(gates[r1].wires)
    ws1[c1] = w2
    gates[r1].wires = tuple(ws1)
    ws2 = list(gates[r2].wires)
    ws2[c2] = w1
    gates[r2].wires = tuple(ws2)
