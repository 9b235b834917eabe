"""Host witness generators + gadget constructors for the always-on gates.

Mirrors the reference witness builders (exact semantics, host ints):
  - Poseidon gadget + witness  (poseidon.rs:102-280)
  - CompleteAdd witness        (complete_add.rs:215-320)
  - VarBaseMul witness         (varbasemul.rs:150-410)
  - EndoMul witness            (endosclmul.rs:60-200)
  - EndomulScalar witness      (endomul_scalar.rs:230-320)

Witness generation is irregular per-gate host work, off the proving
critical path (SURVEY.md §7 hard part 6).

Counterpart of proof_systems_tpu/circuits/polynomials/witness_gen.py, host
code as there (its unused helper and locals dropped).
"""

from __future__ import annotations

from ...curves import CurveParams
from ...fields import FieldParams
from ...poseidon.params import PoseidonParams
from ..gate import COLUMNS, CircuitGate, GateType, new_wires
from .gates import round_cols

ROUNDS_PER_ROW = 5
POS_ROWS_PER_HASH = 11  # 55 rounds / 5 per row


def new_witness(rows: int) -> list[list[int]]:
    return [[0] * rows for _ in range(COLUMNS)]


# -- Poseidon ---------------------------------------------------------------


def create_poseidon_gadget(
    f: FieldParams, row: int, params: PoseidonParams
) -> tuple[list[CircuitGate], int]:
    """POS_ROWS_PER_HASH poseidon gates + a trailing Zero output gate."""
    gates = []
    rc = params.round_constants
    for rel in range(POS_ROWS_PER_HASH):
        abs_row = row + rel
        coeffs = []
        for off in range(ROUNDS_PER_ROW):
            rnd = rel * ROUNDS_PER_ROW + off
            coeffs.extend(rc[rnd] if rnd < len(rc) else (0, 0, 0))
        gates.append(CircuitGate(GateType.Poseidon, new_wires(abs_row), [c % f.p for c in coeffs]))
    last = row + POS_ROWS_PER_HASH
    gates.append(CircuitGate.zero(last))
    return gates, last + 1


def poseidon_witness(
    f: FieldParams,
    params: PoseidonParams,
    witness: list[list[int]],
    row: int,
    state: list[int],
) -> list[int]:
    """Fill rows row..row+11 with the permutation trace; returns output state."""
    from ...poseidon.permutation import full_round

    witness[0][row] = state[0]
    witness[1][row] = state[1]
    witness[2][row] = state[2]
    st = list(state)
    for rel in range(POS_ROWS_PER_HASH):
        r = row + rel
        for rnd in range(ROUNDS_PER_ROW):
            target_row = r + 1 if rnd == ROUNDS_PER_ROW - 1 else r
            full_round(params, st, rel * ROUNDS_PER_ROW + rnd)
            cols = round_cols((rnd + 1) % ROUNDS_PER_ROW)
            for c, s in zip(cols, st):
                witness[c][target_row] = s
    return st


# -- CompleteAdd ------------------------------------------------------------


def complete_add_witness_row(
    curve: CurveParams, witness: list[list[int]], row: int, p1, p2
) -> None:
    """Fill one CompleteAdd row for p1 + p2 (both finite affine points)."""
    f = curve.base
    fp = f.p
    x1, y1 = p1
    x2, y2 = p2
    same_x = 1 if x1 == x2 else 0
    if x1 == x2 and (y1 + y2) % fp == 0:
        inf = 1
    else:
        inf = 0
    if same_x:
        s = 3 * x1 * x1 % fp * pow(2 * y1 % fp, -1, fp) % fp if (2 * y1) % fp else 0
        x21_inv = 0
    else:
        s = (y2 - y1) * pow(x2 - x1, -1, fp) % fp
        x21_inv = pow(x2 - x1, -1, fp)
    x3 = (s * s - x1 - x2) % fp
    y3 = (s * (x1 - x3) - y1) % fp
    inf_z = 0
    if y1 != y2 and same_x:
        inf_z = pow((y2 - y1) % fp, -1, fp) * same_x % fp
    vals = [x1, y1, x2, y2, x3, y3, inf, same_x, s, inf_z, x21_inv]
    for c, v in enumerate(vals):
        witness[c][row] = v % fp


# -- VarBaseMul -------------------------------------------------------------


def varbasemul_witness(
    curve: CurveParams,
    witness: list[list[int]],
    row0: int,
    base: tuple[int, int],
    bits_msb: list[int],
    acc0: tuple[int, int],
):
    """5 bits per 2-row chunk (varbasemul.rs:370-410). Returns (acc, n)."""
    f = curve.base
    fp = f.p
    assert len(bits_msb) % 5 == 0
    acc = acc0
    n_acc = 0
    layout_accs = [(0, 2, 3), (0, 7, 8), (0, 9, 10), (0, 11, 12), (0, 13, 14), (1, 0, 1)]
    layout_bits = [(1, 2), (1, 3), (1, 4), (1, 5), (1, 6)]
    layout_ss = [(1, 7), (1, 8), (1, 9), (1, 10), (1, 11)]

    def set_cell(rel_row, col, v):
        witness[col][row0 + 2 * chunk + rel_row] = v % fp

    for chunk in range(len(bits_msb) // 5):
        bs = bits_msb[5 * chunk : 5 * chunk + 5]
        set_cell(0, 4, n_acc)  # n_prev
        set_cell(0, 0, base[0])
        set_cell(0, 1, base[1])
        for i, b in enumerate(bs):
            n_acc = (2 * n_acc + b)
            rr, cx, cy = layout_accs[i]
            set_cell(rr, cx, acc[0])
            set_cell(rr, cy, acc[1])
            rb, cb = layout_bits[i]
            set_cell(rb, cb, b)
            # single_bit_witness (varbasemul.rs:180-226)
            s1 = (acc[1] - base[1] * (2 * b - 1)) * pow((acc[0] - base[0]) % fp, -1, fp) % fp
            rs, cs = layout_ss[i]
            set_cell(rs, cs, s1)
            s1_sq = s1 * s1 % fp
            s2 = (
                2 * acc[1] * pow((2 * acc[0] + base[0] - s1_sq) % fp, -1, fp) - s1
            ) % fp
            out_x = (base[0] + s2 * s2 - s1_sq) % fp
            out_y = ((acc[0] - out_x) * s2 - acc[1]) % fp
            acc = (out_x, out_y)
        rr, cx, cy = layout_accs[5]
        set_cell(rr, cx, acc[0])
        set_cell(rr, cy, acc[1])
        set_cell(0, 5, n_acc)  # n_next
    return acc, n_acc % fp


def create_vbmul_gates(row: int, num_chunks: int) -> list[CircuitGate]:
    gates = []
    for c in range(num_chunks):
        r = row + 2 * c
        gates.append(CircuitGate(GateType.VarBaseMul, new_wires(r), []))
        gates.append(CircuitGate.zero(r + 1))
    return gates


# -- EndoMul ----------------------------------------------------------------


def endomul_witness(
    curve: CurveParams,
    witness: list[list[int]],
    row0: int,
    endo: int,
    base: tuple[int, int],
    bits_msb: list[int],
    acc0: tuple[int, int],
):
    """4 bits per row (endosclmul.rs witness; layout in module docs)."""
    f = curve.base
    fp = f.p
    assert len(bits_msb) % 4 == 0
    acc = acc0
    n = 0
    for rowi in range(len(bits_msb) // 4):
        row = row0 + rowi
        b1, b2, b3, b4 = bits_msb[4 * rowi : 4 * rowi + 4]
        xt, yt = base
        xp, yp = acc
        xq1 = (1 + b1 * (endo - 1)) * xt % fp
        yq1 = (2 * b2 - 1) * yt % fp
        s1 = (yq1 - yp) * pow((xq1 - xp) % fp, -1, fp) % fp
        s1s = s1 * s1 % fp
        # (xp, yp) -> R = (2P + Q1) computed as (P + Q1) + P using the
        # "double-and-add" slope trick (s2 = 2yp/(2xp + xq1 - s1^2) - s1)
        s2 = (2 * yp * pow((2 * xp + xq1 - s1s) % fp, -1, fp) - s1) % fp
        xr = (xq1 + s2 * s2 - s1s) % fp
        yr = ((xp - xr) * s2 - yp) % fp
        xq2 = (1 + b3 * (endo - 1)) * xt % fp
        yq2 = (2 * b4 - 1) * yt % fp
        s3 = (yq2 - yr) * pow((xq2 - xr) % fp, -1, fp) % fp
        s3s = s3 * s3 % fp
        s4 = (2 * yr * pow((2 * xr + xq2 - s3s) % fp, -1, fp) - s3) % fp
        xs = (xq2 + s4 * s4 - s3s) % fp
        ys = ((xr - xs) * s4 - yr) % fp
        inv = pow((xp - xr) % fp * ((xr - xs) % fp) % fp, -1, fp)

        vals = {0: xt, 1: yt, 2: inv, 4: xp, 5: yp, 6: n, 7: xr, 8: yr, 9: s1, 10: s3,
                11: b1, 12: b2, 13: b3, 14: b4}
        for c, v in vals.items():
            witness[c][row] = v % fp
        acc = (xs, ys)
        n = (16 * n + 8 * b1 + 4 * b2 + 2 * b3 + b4) % fp
    # final row carries (xs, ys, n)
    last = row0 + len(bits_msb) // 4
    witness[4][last] = acc[0]
    witness[5][last] = acc[1]
    witness[6][last] = n
    return acc, n


def create_endomul_gates(row: int, num_rows: int) -> list[CircuitGate]:
    gates = [
        CircuitGate(GateType.EndoMul, new_wires(row + i), []) for i in range(num_rows)
    ]
    gates.append(CircuitGate.zero(row + num_rows))
    return gates


# -- EndomulScalar ----------------------------------------------------------


def endomul_scalar_witness(
    f: FieldParams, witness: list[list[int]], row0: int, scalar: int, num_bits: int
):
    """8 crumbs (16 bits) per row (endomul_scalar.rs:230-320)."""
    p = f.p
    assert num_bits % 16 == 0
    bits_msb = [(scalar >> (num_bits - 1 - i)) & 1 for i in range(num_bits)]
    a, b = 2, 2
    n = 0
    inv2 = pow(2, -1, p)
    inv6 = pow(6, -1, p)

    def c_func(x):
        return x * (11 * inv6 % p + x * ((-5 * inv2) % p + x * (2 * pow(3, -1, p)) % p) % p) % p

    def d_func(x):
        return (c_func(x) + (-1 + x * (3 - x)) ) % p

    rows = num_bits // 16
    for r in range(rows):
        row = row0 + r
        witness[0][row] = n
        witness[2][row] = a
        witness[3][row] = b
        for j in range(8):
            b1 = bits_msb[16 * r + 2 * j]
            b0 = bits_msb[16 * r + 2 * j + 1]
            crumb = 2 * b1 + b0
            witness[6 + j][row] = crumb
            n = (4 * n + crumb) % p
            a = (2 * a + c_func(crumb)) % p
            b = (2 * b + d_func(crumb)) % p
        witness[1][row] = n
        witness[4][row] = a
        witness[5][row] = b
    return a, b, n


def create_endomul_scalar_gates(row: int, num_rows: int) -> list[CircuitGate]:
    return [
        CircuitGate(GateType.EndoMulScalar, new_wires(row + i), [])
        for i in range(num_rows)
    ]
