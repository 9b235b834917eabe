"""Circuit gadget builders (generic gate specs + bench circuits).

Mirrors kimchi/src/circuits/polynomials/generic.rs:120-260
(GenericGateSpec / create_generic_gadget) and the BenchmarkCtx circuit
(kimchi/src/bench.rs:42-75): 2^k - 10 Const(1) generic gates.

Counterpart of proof_systems_tpu/circuits/builders.py, host code copied as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..fields import FieldParams
from .gate import COLUMNS, CircuitGate, GateType, new_wires

GENERIC_COEFFS = 5


@dataclass
class GenericGateSpec:
    """One half of a double-generic row: coefficient vector [l, r, o, m, c]."""

    coeffs: list[int]

    @classmethod
    def const(cls, f: FieldParams, value: int) -> "GenericGateSpec":
        return cls([1, 0, 0, 0, (-value) % f.p])

    @classmethod
    def add(cls, f: FieldParams, left=1, right=1, output=-1) -> "GenericGateSpec":
        return cls([left % f.p, right % f.p, output % f.p, 0, 0])

    @classmethod
    def mul(cls, f: FieldParams, output=-1, mul=1) -> "GenericGateSpec":
        return cls([0, 0, output % f.p, mul % f.p, 0])

    @classmethod
    def pub(cls, f: FieldParams) -> "GenericGateSpec":
        return cls([1, 0, 0, 0, 0])


def create_generic_gadget(
    f: FieldParams, row: int, g1: GenericGateSpec, g2: Optional[GenericGateSpec] = None
) -> CircuitGate:
    coeffs = list(g1.coeffs) + (list(g2.coeffs) if g2 else [0] * GENERIC_COEFFS)
    return CircuitGate(GateType.Generic, new_wires(row), coeffs)


def bench_circuit(f: FieldParams, num_gates: int) -> list[CircuitGate]:
    """BenchmarkCtx circuit: Const(1) generic gates (bench.rs:62-75)."""
    return [
        create_generic_gadget(f, row, GenericGateSpec.const(f, 1))
        for row in range(num_gates)
    ]


def bench_witness(num_gates: int) -> list[list[int]]:
    """All-ones witness matching bench_circuit (bench.rs:100-104)."""
    return [[1] * num_gates for _ in range(COLUMNS)]
