"""The plookup-style lookup argument (kimchi/src/circuits/lookup/).

Counterpart of proof_systems_tpu/circuits/lookup.py, host code copied as it
is, with the reference's order of rng draws:
  - fixed tables: 4-bit XOR (tables/xor.rs, id 0, reversed so (0,0,0)
    is last) and the 12-bit range table (tables/range_check.rs, id 1),
  - lookup patterns Xor / Lookup / RangeCheck / ForeignFieldMul with
    their per-row witness layouts (lookups.rs:417-530),
  - the concatenated multi-table with table-id column (index.rs:330-420)
    and the runtime tables' placeholder columns and selector,
  - the snake-shaped sorted multiset (constraints.rs:87-210), the
    aggregation product (constraints.rs:229-330, one inverse a row), and
    the lookup constraint expressions (constraints.rs:374-640),
  - per-pattern selectors (lookups.rs:234-280).

The sorted multiset and the aggregation run on the host (irregular, hash-map
driven); the prover commits, transforms and walks their columns on the
card like every other column.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from ..fields import FieldParams
from . import expr as expr_mod
from .expr import (
    CURR,
    NEXT,
    Cell,
    Challenge,
    Expr,
    Literal,
    UnnormalizedLagrangeBasis,
    VanishesOnZeroKnowledgeAndPreviousRows,
)
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


@dataclass
class LookupConstraintSystem:
    info: LookupInfo
    lookup_table: list[list[int]]  # concatenated columns, padded to n
    table_ids: Optional[list[int]]  # None when all ids are zero
    selectors_d1: dict[LookupPattern, list[int]]
    dummy_entry: JointLookup  # empty entry, table 0
    runtime_tables_spec: Optional[list[tuple[int, int]]] = None  # (id, len)
    runtime_table_offset: Optional[int] = None
    runtime_selector_d1: Optional[list[int]] = None

    @classmethod
    def create(
        cls,
        f: FieldParams,
        gates: list[CircuitGate],
        n: int,
        zk_rows: int,
        fixed_tables: list[LookupTable] | None = None,
        runtime_tables: list[RuntimeTableCfg] | None = None,
    ) -> Optional["LookupConstraintSystem"]:
        info = LookupInfo.from_gates(gates, uses_runtime_tables=runtime_tables is not None)
        if info is None:
            return None
        max_entries = n - zk_rows - 1

        # selectors
        selectors = {pat: [0] * n for pat in info.patterns}
        gate_tables: dict[int, LookupTable] = {}
        for i, g in enumerate(gates[:n]):
            for row_off, idx in ((CURR, i), (NEXT, i + 1)):
                pat = LookupPattern.from_gate(g.typ, row_off)
                if pat:
                    selectors[pat][idx] = 1
                    t = pat.table()
                    if t is not None:
                        gate_tables[t.id] = t

        tables = list(fixed_tables or [])
        for tid in sorted(gate_tables):
            if all(t.id != tid for t in tables):
                tables.append(gate_tables[tid])
        # reference orders gate tables by BTreeSet of the enum (Xor < RangeCheck)

        # runtime tables: placeholder fixed tables (first column + zero
        # column), offset + selector (index.rs:260-330)
        runtime_spec = None
        runtime_offset = None
        runtime_selector = None
        if runtime_tables is not None:
            ids = [rt.id for rt in runtime_tables]
            if len(set(ids)) != len(ids):
                raise ValueError("runtime table duplicates")
            runtime_offset = sum(len(t) for t in tables)
            runtime_len = sum(len(rt) for rt in runtime_tables)
            runtime_selector = (
                [1] * runtime_offset
                + [0] * runtime_len
                + [1] * (n - runtime_offset - runtime_len)
            )
            for i in range(n - zk_rows, n):
                runtime_selector[i] = 0
            runtime_spec = [(rt.id, len(rt)) for rt in runtime_tables]
            for rt in runtime_tables:
                placeholder = [0] * len(rt)
                tables.append(LookupTable(rt.id, [list(rt.first_column), placeholder]))
        total_len = sum(len(t) for t in tables)
        # >= leaves room for the dummy zero row (index.rs:428-434)
        if total_len >= max_entries:
            raise ValueError(f"lookup tables too long: {total_len} >= {max_entries}")

        width = max(
            max((t.width for t in tables), default=0), info.max_joint_size
        )
        cols: list[list[int]] = [[] for _ in range(width)]
        table_ids: list[int] = []
        non_zero_id = False
        for t in tables:
            if t.id == 0 and not t.has_zero_entry():
                # id-0 tables must contain the dummy zero row (index.rs:422-426);
                # if NO id-0 table exists, the zero padding below provides it.
                raise ValueError("table with id 0 must have a zero entry")
            if t.id != 0:
                non_zero_id = True
            table_ids.extend([t.id % f.p] * len(t))
            for i in range(width):
                if i < t.width:
                    cols[i].extend(v % f.p for v in t.data[i])
                else:
                    cols[i].extend([0] * len(t))
        for c in cols:
            c.extend([0] * (n - len(c)))
        table_ids.extend([0] * (n - len(table_ids)))

        return cls(
            info=info,
            lookup_table=cols,
            table_ids=table_ids if non_zero_id else None,
            selectors_d1=selectors,
            dummy_entry=JointLookup(table_id=("constant", 0), entry=[]),
            runtime_tables_spec=runtime_spec,
            runtime_table_offset=runtime_offset,
            runtime_selector_d1=runtime_selector,
        )


# ---------------------------------------------------------------------------
# Prover-side host computations (sorted + aggregation)
# ---------------------------------------------------------------------------


def combined_table_d1(
    lcs: LookupConstraintSystem,
    f: FieldParams,
    joint: int,
    table_id_comb: int,
    runtime_d1: list[int] | None = None,
) -> list[int]:
    """Per-row combined table entries t_i (on d1; the reference combines on
    d8 but only strides 8, prover.rs:505-530). `runtime_d1` is the prover's
    runtime contribution added to the SECOND column (prover.rs:438-450)."""
    p = f.p
    n = len(lcs.lookup_table[0])
    out = []
    for i in range(n):
        acc = 0
        jpow = 1
        for ci, col in enumerate(lcs.lookup_table):
            v = col[i]
            if ci == 1 and runtime_d1 is not None:
                v = (v + runtime_d1[i]) % p
            acc = (acc + jpow * v) % p
            jpow = jpow * joint % p
        if lcs.table_ids is not None:
            acc = (acc + table_id_comb * lcs.table_ids[i]) % p
        out.append(acc)
    return out


def sorted_multiset(
    lcs: LookupConstraintSystem,
    f: FieldParams,
    gates: list[CircuitGate],
    witness: list[list[int]],
    joint: int,
    table_id_comb: int,
    table_d1: list[int],
    zk_rows: int,
) -> list[list[int]]:
    """constraints.rs:87-210 — snake-sorted padded multiset."""
    p = f.p
    n = len(table_d1)
    lookup_rows = n - zk_rows - 1
    dummy = lcs.dummy_entry.evaluate(p, joint, table_id_comb, lambda pos: 0)
    max_per_row = lcs.info.max_per_row

    counts: dict[int, int] = {}
    for t in table_d1[:lookup_rows]:
        counts.setdefault(t, 1)

    by_row = lcs.info.by_row(gates)
    for i, spec in enumerate(by_row[:lookup_rows]):
        padding = max_per_row - len(spec)
        for jl in spec:

            def eval_cell(pos, i=i):
                row, col = pos
                return witness[col][i if row == CURR else i + 1]

            v = jl.evaluate(p, joint, table_id_comb, eval_cell)
            if v not in counts:
                raise ValueError(f"value not in table at row {i}")
            counts[v] += 1
        counts[dummy] = counts.get(dummy, 0) + padding

    sorted_cols: list[list[int]] = [[] for _ in range(max_per_row + 1)]
    i = 0
    for t in table_d1[:lookup_rows]:
        cnt = counts.get(t)
        if cnt is None:
            raise ValueError("value disappeared from count table")
        counts[t] = 1
        for j in range(cnt):
            idx = i + j
            sorted_cols[idx // lookup_rows].append(t)
        i += cnt
    for k in range(max_per_row):
        sorted_cols[k].append(sorted_cols[k + 1][0])
    sorted_cols[max_per_row].append(sorted_cols[max_per_row][-1])
    for k in range(1, max_per_row + 1, 2):
        sorted_cols[k].reverse()
    return sorted_cols


def zk_patch(f: FieldParams, e: list[int], n: int, zk_rows: int, rng) -> list[int]:
    out = list(e) + [0] * (n - zk_rows - len(e))
    out.extend(rng.field(f.p) for _ in range(zk_rows))
    return out


def aggregation(
    lcs: LookupConstraintSystem,
    f: FieldParams,
    gates: list[CircuitGate],
    witness: list[list[int]],
    joint: int,
    table_id_comb: int,
    beta: int,
    gamma: int,
    sorted_cols: list[list[int]],
    table_d1: list[int],
    zk_rows: int,
    rng,
) -> list[int]:
    """constraints.rs:229-330 — the aggregation ratio product."""
    p = f.p
    n = len(table_d1)
    lookup_rows = n - zk_rows - 1
    beta1 = (1 + beta) % p
    gammabeta1 = gamma * beta1 % p
    max_per_row = lcs.info.max_per_row
    dummy = lcs.dummy_entry.evaluate(p, joint, table_id_comb, lambda pos: 0)

    aggreg = [1]
    for row in range(lookup_rows):
        denom = 1
        for i, s in enumerate(sorted_cols):
            i1, i2 = (row, row + 1) if i % 2 == 0 else (row + 1, row)
            denom = denom * ((gammabeta1 + s[i1] + beta * s[i2]) % p) % p
        aggreg.append(pow(denom, -1, p))

    complements = [1]
    x = (gamma + dummy) % p
    for i in range(1, max_per_row + 1):
        complements.append(complements[i - 1] * x % p)
    b1pr = pow(beta1, max_per_row, p)
    complements = [c * b1pr % p for c in complements]

    by_row = lcs.info.by_row(gates)
    for i in range(lookup_rows):
        t0, t1 = table_d1[i], table_d1[i + 1]
        spec = by_row[i]

        def eval_cell(pos, i=i):
            row, col = pos
            return witness[col][i if row == CURR else i + 1]

        f_chunk = complements[max_per_row - len(spec)]
        for jl in spec:
            f_chunk = f_chunk * ((gamma + jl.evaluate(p, joint, table_id_comb, eval_cell)) % p) % p
        aggreg[i + 1] = aggreg[i + 1] * f_chunk % p
        aggreg[i + 1] = aggreg[i + 1] * ((gammabeta1 + t0 + beta * t1) % p) % p
        aggreg[i + 1] = aggreg[i + 1] * aggreg[i] % p

    if aggreg[lookup_rows] != 1:
        raise ValueError("lookup aggregation incorrect")
    return zk_patch(f, aggreg, n, zk_rows, rng)


# ---------------------------------------------------------------------------
# Constraints (expression AST)
# ---------------------------------------------------------------------------


def constraints(lcs: LookupConstraintSystem, f: FieldParams) -> list[Expr]:
    """constraints.rs:374-640 (no runtime tables yet): 7 expressions."""
    info = lcs.info
    beta = Challenge("beta")
    gamma = Challenge("gamma")
    joint = Challenge("joint_combiner")
    one = Literal(1)
    gammabeta1 = gamma * (beta + one)

    lookup_indicator: Expr = Literal(0)
    for pat in info.patterns:
        lookup_indicator = lookup_indicator + Cell(col_lookup_kind(pat), CURR)
    non_lookup_indicator = one - lookup_indicator

    table_id_comb: Expr = joint
    for _ in range(1, info.max_joint_size):
        table_id_comb = table_id_comb * joint
    if lcs.table_ids is None:
        table_id_comb = Literal(0)

    dummy_lookup: Expr = Literal(0)  # empty entry, table id 0

    beta1_per_row: Expr = one + beta
    for _ in range(1, info.max_per_row):
        beta1_per_row = beta1_per_row * (one + beta)

    def dummy_padding(spec_len: int) -> Expr:
        res: Expr = one
        dummy_term = gamma + dummy_lookup
        for _ in range(spec_len, info.max_per_row):
            res = res * dummy_term
        return res * beta1_per_row

    def f_term(spec: list[JointLookup]) -> Expr:
        res = dummy_padding(len(spec))
        for jl in spec:
            res = res * (gamma + jl.evaluate_expr(joint, table_id_comb))
        return res

    f_chunk: Expr = non_lookup_indicator * f_term([])
    for pat in info.patterns:
        f_chunk = f_chunk + Cell(col_lookup_kind(pat), CURR) * f_term(pat.lookups())

    t_chunk = (
        gammabeta1
        + Cell(COL_LOOKUP_TABLE, CURR)
        + beta * Cell(COL_LOOKUP_TABLE, NEXT)
    )
    numerator = f_chunk * t_chunk

    denominator: Expr = one
    for i in range(info.max_per_row + 1):
        s1, s2 = (CURR, NEXT) if i % 2 == 0 else (NEXT, CURR)
        denominator = denominator * (
            gammabeta1
            + Cell(col_lookup_sorted(i), s1)
            + beta * Cell(col_lookup_sorted(i), s2)
        )

    aggreg_eq = (
        Cell(COL_LOOKUP_AGGREG, NEXT) * denominator
        - Cell(COL_LOOKUP_AGGREG, CURR) * numerator
    )

    res = [
        VanishesOnZeroKnowledgeAndPreviousRows() * aggreg_eq,
        UnnormalizedLagrangeBasis(0) * (Cell(COL_LOOKUP_AGGREG, CURR) - one),
        UnnormalizedLagrangeBasis(-1, zk_anchored=True)
        * (Cell(COL_LOOKUP_AGGREG, CURR) - one),
    ]
    for i in range(info.max_per_row):
        basis = (
            UnnormalizedLagrangeBasis(-1, zk_anchored=True)
            if i % 2 == 0
            else UnnormalizedLagrangeBasis(0)
        )
        res.append(
            basis * (Cell(col_lookup_sorted(i), CURR) - Cell(col_lookup_sorted(i + 1), CURR))
        )
    res.extend(Literal(0) for _ in range(info.max_per_row, 4))
    if lcs.runtime_selector_d1 is not None:
        # runtime tables: rt * selector_RT = 0 (runtime_tables.rs:69-83,
        # appended after the fixed-position padding, constraints.rs:654)
        res.append(
            Cell(COL_LOOKUP_RUNTIME_TABLE, CURR)
            * Cell(COL_LOOKUP_RUNTIME_SELECTOR, CURR)
        )
    return res
