"""Lookup types of the plookup-style argument (kimchi/src/circuits/lookup/):
fixed tables, lookup patterns, joint lookups, LookupInfo and the lookup
column tags.

Counterpart of proof_systems_tpu/circuits/lookup.py up to its
LookupConstraintSystem (l.1-250), host code copied as it is: what the
constraint system needs to recognise a circuit with lookups. The constraint
system, the sorted multiset, the aggregation and the lookup constraints come
with ROADMAP Queue 1 item 8; until then ConstraintSystem.create refuses such
a circuit.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from . import expr as expr_mod
from .expr import CURR, NEXT, Cell, Expr, Literal
from .gate import CircuitGate, GateType

XOR_TABLE_ID = 0
RANGE_CHECK_TABLE_ID = 1


@dataclass
class LookupTable:
    id: int
    data: list[list[int]]  # columns

    def __len__(self) -> int:
        return len(self.data[0])

    @property
    def width(self) -> int:
        return len(self.data)

    def has_zero_entry(self) -> bool:
        return any(all(col[i] == 0 for col in self.data) for i in range(len(self)))


def xor_table() -> LookupTable:
    cols: list[list[int]] = [[], [], []]
    for i in range(16):
        for j in range(16):
            cols[0].append(i)
            cols[1].append(j)
            cols[2].append(i ^ j)
    for c in cols:
        c.reverse()
    return LookupTable(XOR_TABLE_ID, cols)


def range_check_table() -> LookupTable:
    return LookupTable(RANGE_CHECK_TABLE_ID, [list(range(1 << 12))])


class LookupPattern(enum.Enum):
    Xor = "xor"
    Lookup = "lookup"
    RangeCheck = "range_check"
    ForeignFieldMul = "ffmul"

    def max_lookups_per_row(self) -> int:
        return 3 if self is LookupPattern.Lookup else 4

    def max_joint_size(self) -> int:
        return {"xor": 3, "lookup": 2, "range_check": 1, "ffmul": 1}[self.value]

    def lookups(self) -> list["JointLookup"]:
        if self is LookupPattern.Xor:
            return [
                JointLookup(
                    table_id=("constant", XOR_TABLE_ID),
                    entry=[[(1, (CURR, 3 + i))], [(1, (CURR, 7 + i))], [(1, (CURR, 11 + i))]],
                )
                for i in range(4)
            ]
        if self is LookupPattern.Lookup:
            return [
                JointLookup(
                    table_id=("witness", 0),
                    entry=[[(1, (CURR, 2 * i + 1))], [(1, (CURR, 2 * i + 2))]],
                )
                for i in range(3)
            ]
        if self is LookupPattern.RangeCheck:
            return [
                JointLookup(
                    table_id=("constant", RANGE_CHECK_TABLE_ID),
                    entry=[[(1, (CURR, col))]],
                )
                for col in range(3, 7)
            ]
        return [
            JointLookup(
                table_id=("constant", RANGE_CHECK_TABLE_ID), entry=[[(1, (CURR, col))]]
            )
            for col in range(7, 11)
        ]

    def table(self) -> Optional[LookupTable]:
        if self is LookupPattern.Xor:
            return xor_table()
        if self in (LookupPattern.RangeCheck, LookupPattern.ForeignFieldMul):
            return range_check_table()
        return None

    @staticmethod
    def from_gate(gate_type: GateType, row: int) -> Optional["LookupPattern"]:
        """lookups.rs:540-556 (row: CURR or NEXT)."""
        g = gate_type
        if g == GateType.Lookup and row == CURR:
            return LookupPattern.Lookup
        if (g == GateType.RangeCheck0 and row == CURR) or g == GateType.RangeCheck1 or (
            g == GateType.Rot64 and row == CURR
        ):
            if g == GateType.RangeCheck1 or row == CURR:
                return LookupPattern.RangeCheck
        if g == GateType.ForeignFieldMul:
            return LookupPattern.ForeignFieldMul
        if g == GateType.Xor16 and row == CURR:
            return LookupPattern.Xor
        return None


@dataclass
class JointLookup:
    """A (possibly multi-column) lookup: entry[i] = Σ coeff·witness[pos]."""

    table_id: tuple  # ("constant", i32) | ("witness", col)
    entry: list[list[tuple[int, tuple[int, int]]]]  # per column: [(coeff, (row, col))]

    def evaluate(self, p: int, joint: int, table_id_comb: int, eval_cell) -> int:
        acc = 0
        jpow = 1
        for single in self.entry:
            v = 0
            for coeff, pos in single:
                v = (v + coeff * eval_cell(pos)) % p
            acc = (acc + jpow * v) % p
            jpow = jpow * joint % p
        if self.table_id[0] == "constant":
            acc = (acc + table_id_comb * (self.table_id[1] % p)) % p
        else:
            acc = (acc + table_id_comb * eval_cell((CURR, self.table_id[1]))) % p
        return acc

    def evaluate_expr(self, joint: Expr, table_id_comb: Expr) -> Expr:
        acc: Expr = Literal(0)
        jpow: Expr | None = None
        for single in self.entry:
            v: Expr = Literal(0)
            for coeff, (row, col) in single:
                cell = Cell(expr_mod.col_witness(col), row)
                v = v + (cell if coeff == 1 else Literal(coeff) * cell)
            acc = acc + (v if jpow is None else jpow * v)
            jpow = joint if jpow is None else jpow * joint
        if self.table_id[0] == "constant":
            if self.table_id[1] != 0:
                acc = acc + table_id_comb * Literal(self.table_id[1])
        else:
            acc = acc + table_id_comb * Cell(expr_mod.col_witness(self.table_id[1]), CURR)
        return acc


@dataclass
class LookupInfo:
    patterns: list[LookupPattern]
    max_per_row: int
    max_joint_size: int
    joint_lookup_used: bool
    uses_runtime_tables: bool = False

    @classmethod
    def from_gates(cls, gates: list[CircuitGate], uses_runtime_tables: bool = False):
        patterns = []
        joint = uses_runtime_tables
        for g in gates:
            for row in (CURR, NEXT):
                pat = LookupPattern.from_gate(g.typ, row)
                if pat and pat not in patterns:
                    patterns.append(pat)
        if not patterns:
            return None
        patterns.sort(key=lambda q: list(LookupPattern).index(q))
        max_per_row = max(q.max_lookups_per_row() for q in patterns)
        max_joint = max(q.max_joint_size() for q in patterns)
        joint = joint or any(q.max_joint_size() > 1 for q in patterns)
        return cls(patterns, max_per_row, max_joint, joint, uses_runtime_tables)

    def by_row(self, gates: list[CircuitGate]) -> list[list[JointLookup]]:
        kinds: list[list[JointLookup]] = [[] for _ in range(len(gates) + 1)]
        for i, g in enumerate(gates):
            pat = LookupPattern.from_gate(g.typ, CURR)
            if pat:
                kinds[i] = pat.lookups()
            pat = LookupPattern.from_gate(g.typ, NEXT)
            if pat:
                kinds[i + 1] = pat.lookups()
        return kinds


def col_lookup_sorted(i: int):
    return ("lookup_sorted", i)


COL_LOOKUP_AGGREG = ("lookup_aggreg",)
COL_LOOKUP_TABLE = ("lookup_table",)


def col_lookup_kind(pattern: LookupPattern):
    return ("lookup_kind", pattern.value)


COL_LOOKUP_RUNTIME_SELECTOR = ("lookup_runtime_selector",)
COL_LOOKUP_RUNTIME_TABLE = ("lookup_runtime_table",)


@dataclass
class RuntimeTableCfg:
    """Setup-time runtime table configuration: the id and the FIXED first
    (index) column; the second column is supplied at prove time
    (lookup/runtime_tables.rs:25)."""

    id: int
    first_column: list[int]

    def __len__(self) -> int:
        return len(self.first_column)
