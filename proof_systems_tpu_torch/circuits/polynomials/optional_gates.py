"""The optional (feature-flagged) kimchi gates, in the order their
selectors follow the always-on ones (proof_systems_tpu/circuits/polynomials/
optional_gates.py:243). Their constraint builders are not ported yet: a
circuit that uses one is refused by ConstraintSystem.create (ROADMAP Queue 1
item 9)."""

from __future__ import annotations

from ..gate import GateType

OPTIONAL_GATE_ORDER = [
    GateType.RangeCheck0,
    GateType.RangeCheck1,
    GateType.ForeignFieldAdd,
    GateType.ForeignFieldMul,
    GateType.Xor16,
    GateType.Rot64,
]
