"""Snarky-style circuit-writing DSL.

Capability mirror of kimchi/src/snarky/{runner,constraint_system}.rs:
a monadic-feel circuit writer where field variables are symbolic linear
combinations, `exists` allocates witness values, and assertions compile
to double-generic PLONK rows with copy-constraint wiring
(constraint_system.rs add_constraint:1304, compute_witness:416).

Differences by design (pythonic, TPU-first): no OCaml FFI surface, no
lazy As_prover closures — the runner executes in "prover mode" carrying
concrete values alongside the symbolic circuit, so one pass yields both
the gate list and the witness columns (the reference runs checked /
witness-generation as separate passes).

Counterpart of proof_systems_tpu/circuits/snarky.py, host code copied as it
is: the same gates, wiring and witness columns for the same program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..fields import FieldParams
from .gate import COLUMNS, CircuitGate, GateType, Wire, new_wires


class FieldVar:
    """A symbolic linear combination  sum coeff_i * v_i + const."""

    __slots__ = ("rs", "terms", "const")

    def __init__(self, rs: "Runner", terms: Dict[int, int], const: int = 0):
        self.rs = rs
        p = rs.p
        self.terms = {v: c % p for v, c in terms.items() if c % p}
        self.const = const % p

    # -- linear ops are free -----------------------------------------------

    def _lift(self, other) -> "FieldVar":
        if isinstance(other, FieldVar):
            return other
        return FieldVar(self.rs, {}, other)

    def __add__(self, other) -> "FieldVar":
        o = self._lift(other)
        t = dict(self.terms)
        for v, c in o.terms.items():
            t[v] = t.get(v, 0) + c
        return FieldVar(self.rs, t, self.const + o.const)

    __radd__ = __add__

    def __neg__(self) -> "FieldVar":
        return self.scale(-1)

    def __sub__(self, other) -> "FieldVar":
        return self + (-self._lift(other))

    def __rsub__(self, other) -> "FieldVar":
        return self._lift(other) - self

    def scale(self, k: int) -> "FieldVar":
        return FieldVar(
            self.rs, {v: c * k for v, c in self.terms.items()}, self.const * k
        )

    def __mul__(self, other) -> "FieldVar":
        """Multiplication allocates a product variable + one R1CS row
        (runner.rs mul) unless one side is constant."""
        o = self._lift(other)
        if not o.terms:
            return self.scale(o.const)
        if not self.terms:
            return o.scale(self.const)
        return self.rs.mul(self, o)

    __rmul__ = __mul__

    def value(self) -> int:
        rs = self.rs
        acc = self.const
        for v, c in self.terms.items():
            acc += c * rs.values[v]
        return acc % rs.p


@dataclass
class _Position:
    row: int
    col: int


class Runner:
    """RunState (runner.rs:53): allocates variables, accumulates gates,
    tracks copy positions, and (in prover mode) concrete values."""

    def __init__(self, f: FieldParams, public: int = 0):
        self.f = f
        self.p = f.p
        self.values: List[int] = []
        self.gates: List[CircuitGate] = []
        self.rows: List[List[Optional[int]]] = []  # per row: var id per column
        self.positions: Dict[int, List[_Position]] = {}
        self.public = public
        self.public_vars = [self._alloc(0) for _ in range(public)]
        for v in self.public_vars:
            self._public_row(v)
        self.finalized = False

    # -- allocation --------------------------------------------------------

    def _alloc(self, value: int) -> int:
        self.values.append(value % self.p)
        return len(self.values) - 1

    def exists(self, compute: Callable[[], int] | int) -> FieldVar:
        """Allocate a witness variable (runner.rs compute/exists)."""
        value = compute() if callable(compute) else compute
        v = self._alloc(value)
        return FieldVar(self, {v: 1})

    def constant(self, c: int) -> FieldVar:
        return FieldVar(self, {}, c)

    def set_public(self, i: int, value: int) -> FieldVar:
        self.values[self.public_vars[i]] = value % self.p
        return FieldVar(self, {self.public_vars[i]: 1})

    # -- gate emission -----------------------------------------------------

    def _public_row(self, v: int) -> None:
        row = len(self.gates)
        self.gates.append(
            CircuitGate(GateType.Generic, new_wires(row), [1, 0, 0, 0, 0])
        )
        self.rows.append([v] + [None] * (COLUMNS - 1))
        self.positions.setdefault(v, []).append(_Position(row, 0))

    def _generic_row(
        self, cells: List[Optional[int]], coeffs: List[int]
    ) -> int:
        """Emit one generic row; cells are var ids for cols 0..2 (and
        3..5 for the second half when 10 coeffs are given)."""
        row = len(self.gates)
        self.gates.append(
            CircuitGate(
                GateType.Generic, new_wires(row), [c % self.p for c in coeffs]
            )
        )
        filled = list(cells) + [None] * (COLUMNS - len(cells))
        self.rows.append(filled)
        for colno, v in enumerate(filled):
            if v is not None:
                self.positions.setdefault(v, []).append(_Position(row, colno))
        return row

    def _gadget_rows(
        self,
        gates: List[CircuitGate],
        cells: List[List[Optional[int]]],
    ) -> int:
        """Append pre-built gate rows whose cells are var ids (None =
        unconstrained zero). Rows must be contiguous from the current
        row; the gates' wires are translated — a gadget's INTERNAL copy
        wiring (e.g. the multi-range-check MSB cycles) is preserved.
        Cells participating in internal wiring must carry fresh
        single-use vars so finalize()'s var cycles don't overwrite it."""
        base = len(self.gates)
        row0 = gates[0].wires[0].row  # col 0 is identity in our creators
        if gates[0].wires[0] != Wire(row0, 0):
            raise ValueError(
                "_gadget_rows: gates[0].wires[0] must be the identity "
                f"self-reference Wire(row0, 0); got {gates[0].wires[0]!r} — "
                "a creator whose first gate wires col 0 elsewhere would "
                "shift every translated wire"
            )
        for k, gate in enumerate(gates):
            row = base + k
            wires = tuple(
                Wire(w.row - row0 + base, w.col) for w in gate.wires
            )
            for w in wires:
                if not (base <= w.row < base + len(gates)):
                    raise ValueError(
                        f"_gadget_rows: translated wire {w!r} escapes the "
                        f"gadget's row span [{base}, {base + len(gates)})"
                    )
            self.gates.append(CircuitGate(gate.typ, wires, list(gate.coeffs)))
            filled = list(cells[k]) + [None] * (COLUMNS - len(cells[k]))
            self.rows.append(filled)
            for colno, v in enumerate(filled):
                if v is not None:
                    self.positions.setdefault(v, []).append(_Position(row, colno))
        return base

    # -- kimchi gadget constraints (constraint_system.rs:244
    # KimchiConstraint::{Poseidon, EcAddComplete} compilation) -------------

    def poseidon(self, params, inputs: List[FieldVar]) -> List[FieldVar]:
        """Hash a width-3 state with the kimchi Poseidon gadget: 11
        Poseidon gate rows + 1 output row (add_constraint Poseidon arm,
        constraint_system.rs; gadget shape from polynomials/poseidon.rs)."""
        from .polynomials import witness_gen as wg

        assert len(inputs) == 3
        in_vars = [self._single(x) for x in inputs]
        # materialize exact input values (coeff * var + const)
        in_vals = [
            (c * self.values[v] + k) % self.p for (c, v, k) in in_vars
        ]
        gates, _ = wg.create_poseidon_gadget(self.f, len(self.gates), params)
        nrows = len(gates)
        tmp = wg.new_witness(nrows)
        wg.poseidon_witness(self.f, params, tmp, 0, in_vals)
        cells: List[List[Optional[int]]] = []
        for r in range(nrows):
            cells.append([self._alloc(tmp[c][r]) for c in range(COLUMNS)])
        # wire the caller's inputs into row 0 cols 0..2 via copy cycles:
        # replace the fresh vars with the reduced input vars
        for i, (coeff, v, k) in enumerate(in_vars):
            if coeff == 1 and k == 0:
                cells[0][i] = v
            # else: keep the fresh var carrying the evaluated value and
            # pin it to the lincom with one generic row
            else:
                fresh = cells[0][i]
                self._generic_row(
                    [v, fresh, None],
                    [coeff, -1 % self.p, 0, 0, k],
                )
        self._gadget_rows(gates, cells)
        out = cells[-1][:3]
        return [FieldVar(self, {v: 1}) for v in out]

    def ec_add_complete(
        self, curve, p1: Tuple[FieldVar, FieldVar], p2: Tuple[FieldVar, FieldVar]
    ) -> Tuple[FieldVar, FieldVar]:
        """Complete EC addition gadget: one CompleteAdd row
        (KimchiConstraint::EcAddComplete; polynomials/complete_add.rs).
        Points must be distinct-or-equal affine non-infinity values."""
        from .gate import GateType as GT
        from .polynomials import witness_gen as wg

        assert curve.base is self.f, (
            "curve points must live over the circuit field (an Fp circuit "
            "verifies Pallas point arithmetic, not Vesta)"
        )
        vars_in = [self._single(c) for pt in (p1, p2) for c in pt]
        vals = [(c * self.values[v] + k) % self.p for (c, v, k) in vars_in]
        a = (vals[0], vals[1])
        b = (vals[2], vals[3])
        tmp = wg.new_witness(1)
        wg.complete_add_witness_row(curve, tmp, 0, a, b)
        cells: List[Optional[int]] = [self._alloc(tmp[c][0]) for c in range(COLUMNS)]
        for i, (coeff, v, k) in enumerate(vars_in):
            if coeff == 1 and k == 0:
                cells[i] = v
            else:
                self._generic_row([v, cells[i], None], [coeff, -1 % self.p, 0, 0, k])
        gate = CircuitGate(GT.CompleteAdd, new_wires(0), [])
        self._gadget_rows([gate], [cells])
        return (FieldVar(self, {cells[4]: 1}), FieldVar(self, {cells[5]: 1}))

    def _bind(self, x: FieldVar) -> Tuple[int, int]:
        """Reduce to a bare var usable as a gadget cell, pinning
        non-trivial lincoms with one generic row. Returns (var, value)."""
        coeff, v, k = self._single(x)
        if coeff == 1 and k == 0:
            return v, self.values[v]
        val = (coeff * self.values[v] + k) % self.p
        fresh = self._alloc(val)
        self._generic_row([v, fresh, None], [coeff, -1 % self.p, 0, 0, k])
        return fresh, val

    def ec_scale(
        self, curve, base: Tuple[FieldVar, FieldVar],
        bits_msb: List[FieldVar], acc0: Tuple[FieldVar, FieldVar],
    ) -> Tuple[FieldVar, FieldVar, FieldVar]:
        """Variable-base scalar multiplication rounds
        (KimchiConstraint::EcScale, constraint_system.rs:1542-1592): one
        VarBaseMul + Zero row pair per 5 bits, the accumulator and the
        bit-counter n chained across chunks by copy wiring. Returns
        (acc_x, acc_y, n) with acc = acc0 shifted per varbasemul.rs
        semantics (the caller applies the shift convention)."""
        from .polynomials import witness_gen as wg

        assert curve.base is self.f
        assert len(bits_msb) % 5 == 0
        nchunks = len(bits_msb) // 5
        bx, bxv = self._bind(base[0])
        by, byv = self._bind(base[1])
        ax, axv = self._bind(acc0[0])
        ay, ayv = self._bind(acc0[1])
        bit_vars = [self._bind(b) for b in bits_msb]
        tmp = wg.new_witness(2 * nchunks)
        wg.varbasemul_witness(
            curve, tmp, 0, (bxv, byv), [v for _, v in bit_vars], (axv, ayv)
        )
        zero_n, _ = self._bind(self.constant(0))
        cells: List[List[Optional[int]]] = []
        acc_vars = (ax, ay)
        n_var = zero_n
        fresh = lambda r, c: self._alloc(tmp[c][r])
        for ch in range(2 * nchunks):
            if ch % 2 == 0:  # VarBaseMul row
                n_next = self._alloc(tmp[5][ch])
                cells.append([
                    bx, by, acc_vars[0], acc_vars[1], n_var, n_next, None,
                    fresh(ch, 7), fresh(ch, 8), fresh(ch, 9), fresh(ch, 10),
                    fresh(ch, 11), fresh(ch, 12), fresh(ch, 13), fresh(ch, 14),
                ])
                n_var = n_next
            else:  # Zero row: final acc + bits + slopes
                acc_vars = (self._alloc(tmp[0][ch]), self._alloc(tmp[1][ch]))
                row = [acc_vars[0], acc_vars[1]]
                row += [bit_vars[5 * (ch // 2) + i][0] for i in range(5)]
                row += [fresh(ch, 7 + i) for i in range(5)]
                cells.append(row)
        gates = wg.create_vbmul_gates(0, nchunks)
        self._gadget_rows(gates, cells)
        return (FieldVar(self, {acc_vars[0]: 1}), FieldVar(self, {acc_vars[1]: 1}),
                FieldVar(self, {n_var: 1}))

    def ec_endoscale(
        self, curve, base: Tuple[FieldVar, FieldVar],
        bits_msb: List[FieldVar], acc0: Tuple[FieldVar, FieldVar],
    ) -> Tuple[FieldVar, FieldVar, FieldVar]:
        """GLV-endomorphism scalar multiplication
        (KimchiConstraint::EcEndoscale, constraint_system.rs:1593-1632):
        one EndoMul row per 4 bits plus a terminal Zero row carrying
        (xs, ys, n). Bit cells live outside the permuted columns (as in
        the reference layout), so callers bind the SCALAR via the
        returned n accumulator, which the gate chain does constrain."""
        from .polynomials import witness_gen as wg

        assert curve.base is self.f
        assert len(bits_msb) % 4 == 0
        nrows = len(bits_msb) // 4
        endo = curve.endos[0]
        bx, bxv = self._bind(base[0])
        by, byv = self._bind(base[1])
        ax, axv = self._bind(acc0[0])
        ay, ayv = self._bind(acc0[1])
        bit_vals = [b.value() for b in bits_msb]
        tmp = wg.new_witness(nrows + 1)
        wg.endomul_witness(curve, tmp, 0, endo, (bxv, byv), bit_vals, (axv, ayv))
        zero_n, _ = self._bind(self.constant(0))
        cells: List[List[Optional[int]]] = []
        acc_vars = (ax, ay)
        n_var = zero_n
        for r in range(nrows):
            nxt_n = self._alloc(tmp[6][r + 1] if r + 1 < nrows else tmp[6][nrows])
            cells.append([
                bx, by, self._alloc(tmp[2][r]), None,
                acc_vars[0], acc_vars[1], n_var,
                self._alloc(tmp[7][r]), self._alloc(tmp[8][r]),
                self._alloc(tmp[9][r]), self._alloc(tmp[10][r]),
                self._alloc(tmp[11][r]), self._alloc(tmp[12][r]),
                self._alloc(tmp[13][r]), self._alloc(tmp[14][r]),
            ])
            acc_vars = (self._alloc(tmp[4][r + 1]), self._alloc(tmp[5][r + 1]))
            n_var = nxt_n
        cells.append([None, None, None, None, acc_vars[0], acc_vars[1], n_var])
        gates = wg.create_endomul_gates(0, nrows)
        self._gadget_rows(gates, cells)
        return (FieldVar(self, {acc_vars[0]: 1}), FieldVar(self, {acc_vars[1]: 1}),
                FieldVar(self, {n_var: 1}))

    def ec_endoscalar(
        self, scalar: FieldVar, num_bits: int
    ) -> Tuple[FieldVar, FieldVar, FieldVar]:
        """Endo-scalar decomposition (KimchiConstraint::EcEndoscalar,
        constraint_system.rs:1633-1653): EndoMulScalar rows recomputing
        ScalarChallenge::to_field's (a, b) from the challenge bits;
        returns (a, b, n) with n constrained to accumulate the scalar's
        bits — callers assert n == scalar."""
        from .polynomials import witness_gen as wg

        assert num_bits % 16 == 0
        nrows = num_bits // 16
        sval = scalar.value()
        assert sval < (1 << num_bits)
        tmp = wg.new_witness(nrows)
        wg.endomul_scalar_witness(self.f, tmp, 0, sval, num_bits)
        two = self._bind(self.constant(2))[0]
        zero_n = self._bind(self.constant(0))[0]
        n_var, a_var, b_var = zero_n, two, two
        cells: List[List[Optional[int]]] = []
        for r in range(nrows):
            n8 = self._alloc(tmp[1][r])
            a8 = self._alloc(tmp[4][r])
            b8 = self._alloc(tmp[5][r])
            cells.append([
                n_var, n8, a_var, b_var, a8, b8,
            ] + [self._alloc(tmp[6 + j][r]) for j in range(8)])
            n_var, a_var, b_var = n8, a8, b8
        gates = wg.create_endomul_scalar_gates(0, nrows)
        self._gadget_rows(gates, cells)
        svar, _ = self._bind(scalar)
        self.assert_eq(FieldVar(self, {n_var: 1}), FieldVar(self, {svar: 1}))
        return (FieldVar(self, {a_var: 1}), FieldVar(self, {b_var: 1}),
                FieldVar(self, {n_var: 1}))

    def range_check(self, v0: FieldVar, v1: FieldVar, v2: FieldVar) -> None:
        """88-bit multi-range-check block (KimchiConstraint::RangeCheck,
        constraint_system.rs:1654-1699): RangeCheck0 ×2 + RangeCheck1 +
        Zero rows; the gadget's internal MSB copy wiring is preserved."""
        from .polynomials import optional_witness as ow
        from .polynomials import witness_gen as wg

        vars_vals = [self._bind(v) for v in (v0, v1, v2)]
        tmp = wg.new_witness(4)
        ow.multi_range_check_witness(
            tmp, 0, vars_vals[0][1], vars_vals[1][1], vars_vals[2][1]
        )
        gates = ow.create_multi_range_check(0)
        cells: List[List[Optional[int]]] = []
        for r in range(4):
            row: List[Optional[int]] = [self._alloc(tmp[c][r]) for c in range(COLUMNS)]
            if r < 3:
                row[0] = vars_vals[r][0]
            cells.append(row)
        self._gadget_rows(gates, cells)

    # -- reduction (constraint_system.rs reduce_lincom) --------------------

    def _single(self, x: FieldVar) -> Tuple[int, int, int]:
        """Reduce to (coeff, var, const) with exactly one variable,
        emitting internal-variable rows for longer combinations."""
        terms = [(v, c) for v, c in x.terms.items()]
        if not terms:
            # constant: bind to a fresh var constrained to the constant
            v = self._alloc(x.const)
            self._generic_row([v], [1, 0, 0, 0, -x.const])
            return 1, v, 0
        if len(terms) == 1:
            (v, c) = terms[0]
            return c, v, x.const
        # fold two terms at a time into internal variables:
        # w = c1 v1 + c2 v2 (+ const on the first fold)
        (v1, c1) = terms[0]
        const = x.const
        for (v2, c2) in terms[1:]:
            wval = (c1 * self.values[v1] + c2 * self.values[v2] + const) % self.p
            w = self._alloc(wval)
            self._generic_row([v1, v2, w], [c1, c2, -1, 0, const])
            v1, c1, const = w, 1, 0
        return c1, v1, 0

    # -- constraints (BasicSnarkyConstraint, constraint_system.rs:175) -----

    def assert_r1cs(self, a: FieldVar, b: FieldVar, c: FieldVar) -> None:
        """(a)(b) = c as one generic row (runner.rs:347)."""
        ca, va, pa = self._single(a)
        cb, vb, pb = self._single(b)
        cc, vc, pc = self._single(c)
        self._generic_row(
            [va, vb, vc],
            [ca * pb, pa * cb, -cc, ca * cb, pa * pb - pc],
        )

    def assert_eq(self, x: FieldVar, y: FieldVar) -> None:
        cx, vx, px = self._single(x)
        cy, vy, py = self._single(y)
        self._generic_row([vx, vy], [cx, -cy, 0, 0, px - py])

    def assert_square(self, x: FieldVar, y: FieldVar) -> None:
        cx, vx, px = self._single(x)
        cy, vy, py = self._single(y)
        # (cx vx + px)^2 = cy vy + py
        self._generic_row(
            [vx, vx, vy],
            [2 * cx * px, 0, -cy, cx * cx, px * px - py],
        )

    def assert_boolean(self, x: FieldVar) -> None:
        cx, vx, px = self._single(x)
        # (cx vx + px)^2 - (cx vx + px) = 0
        self._generic_row(
            [vx, vx],
            [2 * cx * px - cx, 0, 0, cx * cx, px * px - px],
        )

    # -- derived operations ------------------------------------------------

    def mul(self, a: FieldVar, b: FieldVar) -> FieldVar:
        out = self.exists(lambda: a.value() * b.value())
        self.assert_r1cs(a, b, out)
        return out

    def square(self, x: FieldVar) -> FieldVar:
        out = self.exists(lambda: x.value() * x.value())
        self.assert_square(x, out)
        return out

    def inv(self, x: FieldVar) -> FieldVar:
        out = self.exists(lambda: pow(x.value(), -1, self.p))
        self.assert_r1cs(x, out, self.constant(1))
        return out

    def div(self, a: FieldVar, b: FieldVar) -> FieldVar:
        out = self.exists(lambda: a.value() * pow(b.value(), -1, self.p))
        self.assert_r1cs(b, out, a)
        return out

    def if_(self, b: FieldVar, then: FieldVar, else_: FieldVar) -> FieldVar:
        """b * then + (1-b) * else_  (b must be boolean-constrained)."""
        return self.mul(b, then - else_) + else_

    # -- finalization ------------------------------------------------------

    def finalize(self) -> Tuple[List[CircuitGate], List[List[int]]]:
        """Wire copy cycles and build witness columns
        (constraint_system.rs finalize + compute_witness:416)."""
        assert not self.finalized
        self.finalized = True
        from .gate import PERMUTS

        # copy cycles over permuted columns only
        for v, positions in self.positions.items():
            cyc = [pos for pos in positions if pos.col < PERMUTS]
            if len(cyc) <= 1:
                continue
            for i, pos in enumerate(cyc):
                nxt = cyc[(i + 1) % len(cyc)]
                ws = list(self.gates[pos.row].wires)
                ws[pos.col] = Wire(nxt.row, nxt.col)
                self.gates[pos.row].wires = tuple(ws)

        nrows = len(self.rows)
        witness = [[0] * nrows for _ in range(COLUMNS)]
        for r, rowvars in enumerate(self.rows):
            for colno, v in enumerate(rowvars):
                if v is not None:
                    witness[colno][r] = self.values[v]
        return self.gates, witness

    def public_values(self) -> List[int]:
        return [self.values[v] for v in self.public_vars]
