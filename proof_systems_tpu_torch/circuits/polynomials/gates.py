"""Constraint definitions for the always-on kimchi gates.

Each function returns the gate's constraint list as expression ASTs,
mirroring the reference `Argument::constraint_checks` implementations:
  - Generic:       kimchi/src/circuits/polynomials/generic.rs:80  (2)
  - Poseidon:      poseidon.rs:350                               (15)
  - CompleteAdd:   complete_add.rs:102                            (7)
  - VarBaseMul:    varbasemul.rs:418                             (21)
  - EndosclMul:    endosclmul.rs:474                             (12)
  - EndomulScalar: endomul_scalar.rs:173                         (11)

`combined(...)` multiplies the α-combined constraints by the gate's
selector column (argument.rs:200-213).

Counterpart of proof_systems_tpu/circuits/polynomials/gates.py, host code copied as it is.
"""

from __future__ import annotations

from ...fields import FieldParams
from ..expr import ArgumentEnv, Cell, Expr, Literal, combine_constraints, col_index
from ..gate import GateType

ENV = ArgumentEnv()

GATE_CONSTRAINTS = {
    GateType.Generic: 2,
    GateType.Poseidon: 15,
    GateType.CompleteAdd: 7,
    GateType.VarBaseMul: 21,
    GateType.EndoMul: 12,
    GateType.EndoMulScalar: 11,
}

# Poseidon layout (poseidon.rs:64-79): order in which the 5 per-row states
# are stored; round i state lives at columns 3*STATE_ORDER[i]..+3.
STATE_ORDER = [0, 2, 3, 4, 1]
ROUND_EQUATIONS = [(0, (0, 1)), (1, (0, 2)), (2, (0, 3)), (3, (0, 4)), (4, (1, 0))]
SPONGE_WIDTH = 3


def round_cols(i: int) -> range:
    s = STATE_ORDER[i] * SPONGE_WIDTH
    return range(s, s + SPONGE_WIDTH)


def generic_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    out = []
    for off_c, off_w in ((0, 0), (5, 3)):
        l, r, o = (env.witness_curr(off_w + i) for i in range(3))
        cl, cr, co, cm, cc = (env.coeff(off_c + i) for i in range(5))
        out.append(cl * l + cr * r + co * o + cm * l * r + cc)
    return out


def poseidon_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    res = []
    idx = 0
    mds = [[env.mds(r, c) for c in range(3)] for r in range(3)]
    for source, (target_row, target_round) in ROUND_EQUATIONS:
        sboxed = [env.witness_curr(i) ** 7 for i in round_cols(source)]
        for j, col in enumerate(round_cols(target_round)):
            rc = env.coeff(idx)
            idx += 1
            cell = env.witness_curr(col) if target_row == 0 else env.witness_next(col)
            acc = rc
            for k in range(3):
                acc = acc + mds[j][k] * sboxed[k]
            res.append(cell - acc)
    return res


def _zero_check(z: Expr, z_inv: Expr, r: Expr) -> list[Expr]:
    return [z_inv * z - (Literal(1) - r), r * z]


def complete_add_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    x1, y1, x2, y2, x3, y3 = (env.witness_curr(i) for i in range(6))
    inf = env.witness_curr(6)
    same_x = env.witness_curr(7)
    s = env.witness_curr(8)
    inf_z = env.witness_curr(9)
    x21_inv = env.witness_curr(10)

    x21 = x2 - x1
    y21 = y2 - y1
    res = _zero_check(x21, x21_inv, same_x)
    x1_squared = x1 * x1
    dbl_case = s.double() * y1 - x1_squared.double() - x1_squared
    add_case = x21 * s - y21
    res.append(same_x * dbl_case + (Literal(1) - same_x) * add_case)
    res.append(x1 + x2 + x3 - s * s)
    res.append(s * (x1 - x3) - y1 - y3)
    res.append(y21 * (same_x - inf))
    res.append(y21 * inf_z - inf)
    return res


def varbasemul_constraints(f: FieldParams) -> list[Expr]:
    env = ENV

    def v(row, col):
        return env.witness_curr(col) if row == 0 else env.witness_next(col)

    accs = [
        (v(0, 2), v(0, 3)),
        (v(0, 7), v(0, 8)),
        (v(0, 9), v(0, 10)),
        (v(0, 11), v(0, 12)),
        (v(0, 13), v(0, 14)),
        (v(1, 0), v(1, 1)),
    ]
    bits = [v(1, 2), v(1, 3), v(1, 4), v(1, 5), v(1, 6)]
    ss = [v(1, 7), v(1, 8), v(1, 9), v(1, 10), v(1, 11)]
    base = (v(0, 0), v(0, 1))
    n_prev, n_next = v(0, 4), v(0, 5)

    acc = n_prev
    for b in bits:
        acc = b + acc.double()
    res = [n_next - acc]

    for i in range(5):
        b = bits[i]
        s1 = ss[i]
        inp, out = accs[i], accs[i + 1]
        b_sign = b.double() - Literal(1)
        s1_sq = s1 * s1
        rx = s1_sq - inp[0] - base[0]
        t = inp[0] - rx
        u = inp[1].double() - t * s1
        res.append(b.boolean())
        res.append((inp[0] - base[0]) * s1 - (inp[1] - b_sign * base[1]))
        res.append(u * u - (t * t) * (out[0] - base[0] + s1_sq))
        res.append((out[1] + inp[1]) * t - (inp[0] - out[0]) * u)
    return res


def endosclmul_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    b1, b2, b3, b4 = (env.witness_curr(i) for i in (11, 12, 13, 14))
    xt, yt = env.witness_curr(0), env.witness_curr(1)
    inv = env.witness_curr(2)
    xs, ys = env.witness_next(4), env.witness_next(5)
    xp, yp = env.witness_curr(4), env.witness_curr(5)
    xr, yr = env.witness_curr(7), env.witness_curr(8)
    s1, s3 = env.witness_curr(9), env.witness_curr(10)

    endo_minus_1 = env.endo_coefficient() - Literal(1)
    xq1 = (Literal(1) + b1 * endo_minus_1) * xt
    xq2 = (Literal(1) + b3 * endo_minus_1) * xt
    yq1 = (b2.double() - Literal(1)) * yt
    yq2 = (b4.double() - Literal(1)) * yt
    s1_sq = s1.square()
    s3_sq = s3.square()
    n = env.witness_curr(6)
    n_next = env.witness_next(6)
    n_constraint = (
        (((n.double() + b1).double() + b2).double() + b3).double() + b4 - n_next
    )
    xp_xr = xp - xr
    xr_xs = xr - xs
    ys_yr = ys + yr
    yr_yp = yr + yp
    return [
        b1.boolean(),
        b2.boolean(),
        b3.boolean(),
        b4.boolean(),
        ((xq1 - xp) * s1) - (yq1 - yp),
        ((xp.double() - s1_sq) + xq1) * ((xp_xr * s1) + yr_yp) - (yp.double() * xp_xr),
        yr_yp.square() - (xp_xr.square() * ((s1_sq - xq1) + xr)),
        ((xq2 - xr) * s3) - (yq2 - yr),
        ((xr.double() - s3_sq) + xq2) * ((xr_xs * s3) + ys_yr) - (yr.double() * xr_xs),
        ys_yr.square() - (xr_xs.square() * ((s3_sq - xq2) + xs)),
        n_constraint,
        xp_xr * xr_xs * inv - Literal(1),
    ]


def _polynomial(coeffs: list[int], x: Expr) -> Expr:
    acc: Expr = Literal(0)
    for c in reversed(coeffs):
        acc = acc * x + Literal(c)
    return acc


def endomul_scalar_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    p = f.p
    n0 = env.witness_curr(0)
    n8 = env.witness_curr(1)
    a0 = env.witness_curr(2)
    b0 = env.witness_curr(3)
    a8 = env.witness_curr(4)
    b8 = env.witness_curr(5)
    xs = [env.witness_curr(6 + i) for i in range(8)]

    inv6 = pow(6, -1, p)
    inv2 = pow(2, -1, p)
    inv3 = pow(3, -1, p)
    c_coeffs = [0, 11 * inv6 % p, -5 * inv2 % p, 2 * inv3 % p]
    crumb_over_x = [-6 % p, 11, -6 % p, 1]
    d_minus_c = [-1 % p, 3, -1 % p]

    c_funcs = [_polynomial(c_coeffs, x) for x in xs]
    d_funcs = [c_funcs[i] + _polynomial(d_minus_c, xs[i]) for i in range(8)]

    n8_exp: Expr = n0
    for x in xs:
        n8_exp = n8_exp.double().double() + x
    a8_exp: Expr = a0
    for c in c_funcs:
        a8_exp = a8_exp.double() + c
    b8_exp: Expr = b0
    for d in d_funcs:
        b8_exp = b8_exp.double() + d

    constraints = [n8_exp - n8, a8_exp - a8, b8_exp - b8]
    constraints += [_polynomial(crumb_over_x, x) * x for x in xs]
    return constraints


GATE_BUILDERS = {
    GateType.Generic: generic_constraints,
    GateType.Poseidon: poseidon_constraints,
    GateType.CompleteAdd: complete_add_constraints,
    GateType.VarBaseMul: varbasemul_constraints,
    GateType.EndoMul: endosclmul_constraints,
    GateType.EndoMulScalar: endomul_scalar_constraints,
}


def combined(gate: GateType, f: FieldParams, alphas) -> Expr:
    """selector * Σ alpha^i constraint_i (argument.rs combined_constraints)."""
    constraints = GATE_BUILDERS[gate](f)
    assert len(constraints) == GATE_CONSTRAINTS[gate]
    exps = alphas.get_exponents("gate", len(constraints))
    return Cell(col_index(gate), 0) * combine_constraints(exps, constraints)
