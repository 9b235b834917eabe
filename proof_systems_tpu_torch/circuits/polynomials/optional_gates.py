"""Constraints for the optional (feature-flagged) kimchi gates.

Reference implementations:
  - RangeCheck0 (10) / RangeCheck1 (21): range_check/circuitgates.rs:176,280
  - ForeignFieldAdd (4): foreign_field_add/circuitgates.rs:144
  - ForeignFieldMul (11): foreign_field_mul/circuitgates.rs:195
  - Xor16 (3): xor.rs:155
  - Rot64 (11): rot.rs:219

Foreign-field limbs are 88 bits (foreign_field_common.rs:20); the
crumb/carry helpers mirror expr.rs:3394 and ffadd circuitgates.rs:211.

Counterpart of proof_systems_tpu/circuits/polynomials/optional_gates.py,
host code copied as it is: the literals 2^88, 2^176 and 2^264 are taken
mod p, and each present gate's term joins the linearization as
index(g) * sum_i alpha^i c_i in OPTIONAL_GATE_ORDER.
"""

from __future__ import annotations

from ...fields import FieldParams
from ..expr import ArgumentEnv, Expr, Literal
from ..gate import COLUMNS, GateType

ENV = ArgumentEnv()
LIMB_BITS = 88

OPTIONAL_GATE_CONSTRAINTS = {
    GateType.RangeCheck0: 10,
    GateType.RangeCheck1: 21,
    GateType.ForeignFieldAdd: 4,
    GateType.ForeignFieldMul: 11,
    GateType.Xor16: 3,
    GateType.Rot64: 11,
}


def _crumb(x: Expr) -> Expr:
    """x (x-1) (x-2) (x-3)."""
    return x * (x - Literal(1)) * (x - Literal(2)) * (x - Literal(3))


def _two_pow(f: FieldParams, k: int) -> Expr:
    return Literal(pow(2, k, f.p))


def range_check0_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    constraints = [_crumb(env.witness_curr(i)) for i in range(7, COLUMNS)]
    power = 1
    total: Expr = Literal(0)
    for i in reversed(range(7, COLUMNS)):
        total = total + Literal(power % f.p) * env.witness_curr(i)
        power = power * 4 % f.p
    for i in reversed(range(1, 7)):
        total = total + Literal(power % f.p) * env.witness_curr(i)
        power = power * 4096 % f.p
    constraints.append(total - env.witness_curr(0))
    constraints.append(
        env.coeff(0)
        * (
            env.witness_next(1)
            - (env.witness_curr(0) + _two_pow(f, LIMB_BITS) * env.witness_next(0))
        )
    )
    return constraints


def range_check1_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    constraints = [_crumb(env.witness_curr(2))]
    constraints += [_crumb(env.witness_curr(i)) for i in range(7, COLUMNS)]
    constraints += [_crumb(env.witness_next(i)) for i in range(0, 3)]
    constraints += [_crumb(env.witness_next(i)) for i in range(7, COLUMNS)]

    power = 1
    total: Expr = Literal(0)
    for i in reversed(range(7, COLUMNS)):
        total = total + Literal(power % f.p) * env.witness_next(i)
        power = power * 4 % f.p
    for i in reversed(range(0, 3)):
        total = total + Literal(power % f.p) * env.witness_next(i)
        power = power * 4 % f.p
    for i in reversed(range(7, COLUMNS)):
        total = total + Literal(power % f.p) * env.witness_curr(i)
        power = power * 4 % f.p
    for i in reversed(range(3, 7)):
        total = total + Literal(power % f.p) * env.witness_curr(i)
        power = power * 4096 % f.p
    total = total + Literal(power % f.p) * env.witness_curr(2)
    constraints.append(total - env.witness_curr(0))
    return constraints


def _compact_limb(f: FieldParams, lo: Expr, mi: Expr) -> Expr:
    return lo + _two_pow(f, LIMB_BITS) * mi


def foreign_field_add_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    fm = [env.coeff(i) for i in range(3)]
    sign = env.coeff(3)
    a = [env.witness_curr(i) for i in range(3)]
    b = [env.witness_curr(3 + i) for i in range(3)]
    overflow = env.witness_curr(6)
    carry = env.witness_curr(7)
    r = [env.witness_next(i) for i in range(3)]

    checks = [overflow * (overflow - sign)]
    checks.append(carry * (carry - Literal(1)) * (carry + Literal(1)))
    result_bot = (
        _compact_limb(f, a[0], a[1])
        + sign * _compact_limb(f, b[0], b[1])
        - overflow * _compact_limb(f, fm[0], fm[1])
        - carry * _two_pow(f, 2 * LIMB_BITS)
    )
    result_top = a[2] + sign * b[2] - overflow * fm[2] + carry
    checks.append(result_bot - _compact_limb(f, r[0], r[1]))
    checks.append(result_top - r[2])
    return checks


def foreign_field_mul_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    a = [env.witness_curr(i) for i in range(3)]
    b = [env.witness_curr(3 + i) for i in range(3)]
    carry1_crumbs = [env.witness_curr(11), env.witness_curr(12), env.witness_curr(13)]
    carry1_bit = env.witness_curr(14)
    carry1_parts = [
        env.witness_curr(7),
        env.witness_curr(8),
        env.witness_curr(9),
        env.witness_curr(10),
        env.witness_next(8),
        env.witness_next(9),
        env.witness_next(10),
        carry1_crumbs[0],
        carry1_crumbs[1],
        carry1_crumbs[2],
        carry1_bit,
    ]
    carry1: Expr = Literal(0)
    shifts = [0, 12, 24, 36, 48, 60, 72, 84, 86, 88, 90]
    for part, sh in zip(carry1_parts, shifts):
        carry1 = carry1 + _two_pow(f, sh) * part if sh else carry1 + part

    carry0 = env.witness_next(11)
    q = [env.witness_next(2), env.witness_next(3), env.witness_next(4)]
    q_hi_bound = env.witness_next(5)
    r01 = env.witness_next(0)
    r2 = env.witness_next(1)
    p1_lo = env.witness_curr(6)
    p1_hi_0 = env.witness_next(6)
    p1_hi_1 = env.witness_next(7)
    hi_fm = env.coeff(0)
    neg_fm = [env.coeff(1 + i) for i in range(3)]

    two_l = _two_pow(f, LIMB_BITS)
    two_2l = _two_pow(f, 2 * LIMB_BITS)
    two_3l = _two_pow(f, 3 * LIMB_BITS)

    p0 = a[0] * b[0] + q[0] * neg_fm[0]
    p1 = (
        a[0] * b[1] + a[1] * b[0] + q[0] * neg_fm[1] + q[1] * neg_fm[0]
    )
    p2 = (
        a[0] * b[2]
        + a[2] * b[0]
        + a[1] * b[1]
        + q[0] * neg_fm[2]
        + q[2] * neg_fm[0]
        + q[1] * neg_fm[1]
    )
    an = two_2l * a[2] + two_l * a[1] + a[0]
    bn = two_2l * b[2] + two_l * b[1] + b[0]
    qn = two_2l * q[2] + two_l * q[1] + q[0]
    rn = two_2l * r2 + r01
    neg_fmn = two_2l * neg_fm[2] + two_l * neg_fm[1] + neg_fm[0]

    bound = q[2] + two_l - hi_fm - Literal(1)

    product1_hi = two_l * p1_hi_1 + p1_hi_0
    product1 = two_l * product1_hi + p1_lo

    return [
        _crumb(p1_hi_1),  # C1
        _crumb(carry0),  # C2
        p1 - product1,  # C3
        two_2l * carry0 - (p0 + two_l * p1_lo - r01),  # C4
        an * bn + qn * neg_fmn - rn - qn * two_3l,  # C5
        _crumb(carry1_crumbs[0]),  # C6
        _crumb(carry1_crumbs[1]),  # C7
        _crumb(carry1_crumbs[2]),  # C8
        carry1_bit.boolean(),  # C9
        two_l * carry1 - (p2 + product1_hi + carry0 - r2),  # C10
        q_hi_bound - bound,  # C11
    ]


def xor16_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    out = []
    for i in range(3):
        out.append(
            env.witness_curr(3 + 4 * i)
            + env.witness_curr(4 + 4 * i) * _two_pow(f, 4)
            + env.witness_curr(5 + 4 * i) * _two_pow(f, 8)
            + env.witness_curr(6 + 4 * i) * _two_pow(f, 12)
            + _two_pow(f, 16) * env.witness_next(i)
            - env.witness_curr(i)
        )
    return out


def rot64_constraints(f: FieldParams) -> list[Expr]:
    env = ENV
    constraints = [_crumb(env.witness_curr(i)) for i in range(7, COLUMNS)]
    two_64 = _two_pow(f, 64)
    word = env.witness_curr(0)
    rotated = env.witness_curr(1)
    excess = env.witness_curr(2)
    shifted = env.witness_next(0)
    two_to_rot = env.coeff(0)
    constraints.append(word * two_to_rot - (excess * two_64 + shifted))
    constraints.append(rotated - (shifted + excess))
    power = 1
    bound: Expr = Literal(0)
    for i in reversed(range(7, COLUMNS)):
        bound = bound + Literal(power % f.p) * env.witness_curr(i)
        power = power * 4 % f.p
    for i in reversed(range(3, 7)):
        bound = bound + Literal(power % f.p) * env.witness_curr(i)
        power = power * 4096 % f.p
    constraints.append(bound - (excess - two_to_rot + two_64))
    return constraints


OPTIONAL_GATE_BUILDERS = {
    GateType.RangeCheck0: range_check0_constraints,
    GateType.RangeCheck1: range_check1_constraints,
    GateType.ForeignFieldAdd: foreign_field_add_constraints,
    GateType.ForeignFieldMul: foreign_field_mul_constraints,
    GateType.Xor16: xor16_constraints,
    GateType.Rot64: rot64_constraints,
}

# linearization inclusion order (linearization.rs:70-165)
OPTIONAL_GATE_ORDER = [
    GateType.RangeCheck0,
    GateType.RangeCheck1,
    GateType.ForeignFieldAdd,
    GateType.ForeignFieldMul,
    GateType.Xor16,
    GateType.Rot64,
]
