"""Gadget constructors + witness fillers for the optional gates.

Mirrors:
  - range_check/gadget.rs:30-110 + witness.rs:29-110 (multi-range-check:
    rows [RangeCheck0 v0, RangeCheck0 v1, RangeCheck1 v2, Zero] with the
    4 MSB-copy wire connections),
  - xor.rs:183-230 (num_xors 16-bit chunks + terminating Zero row),
  - rot.rs:47-110,311-360 (Rot64 + two RangeCheck0 rows for shifted and
    excess, excess wired into the Rot64 row).

Counterpart of proof_systems_tpu/circuits/polynomials/optional_witness.py,
host code as there (its unused locals dropped, its copy wiring through
connect_cell_pair).
"""

from __future__ import annotations

from ...fields import FieldParams
from ..gate import CircuitGate, GateType, connect_cell_pair, new_wires

LIMB = 88


def _bits(v: int, lo: int, hi: int) -> int:
    return (v >> lo) & ((1 << (hi - lo)) - 1)


def _rc0_row_values(v: int) -> list[int]:
    return [
        v,
        _bits(v, 76, 88),
        _bits(v, 64, 76),
        _bits(v, 52, 64),
        _bits(v, 40, 52),
        _bits(v, 28, 40),
        _bits(v, 16, 28),
        _bits(v, 14, 16),
        _bits(v, 12, 14),
        _bits(v, 10, 12),
        _bits(v, 8, 10),
        _bits(v, 6, 8),
        _bits(v, 4, 6),
        _bits(v, 2, 4),
        _bits(v, 0, 2),
    ]


def create_multi_range_check(start_row: int, compact: bool = False) -> list[CircuitGate]:
    coeff = 1 if compact else 0
    gates = [
        CircuitGate(GateType.RangeCheck0, new_wires(start_row), [0]),
        CircuitGate(GateType.RangeCheck0, new_wires(start_row + 1), [coeff]),
        CircuitGate(GateType.RangeCheck1, new_wires(start_row + 2), []),
        CircuitGate.zero(start_row + 3),
    ]
    # MSB copies into the Zero row (gadget.rs:100-112); gates list indices
    # are the rows relative to start_row
    for a, b in [((0, 1), (3, 3)), ((0, 2), (3, 4)), ((1, 1), (3, 5)), ((1, 2), (3, 6))]:
        connect_cell_pair(gates, a, b)
    return gates


def multi_range_check_witness(
    witness: list[list[int]], row: int, v0: int, v1: int, v2: int, compact: bool = False
) -> None:
    """witness.rs layout: 4 rows for (v0, v1, v2) 88-bit checks."""
    for c, val in enumerate(_rc0_row_values(v0)):
        witness[c][row] = val
    for c, val in enumerate(_rc0_row_values(v1)):
        witness[c][row + 1] = val
    # compact mode: the caller writes v12 = v1 + 2^88 v2 into row + 2, col 1
    r2 = row + 2
    vals2 = [
        v2,
        0,  # v12 (optional, compact mode)
        _bits(v2, 86, 88),
        _bits(v2, 74, 86),
        _bits(v2, 62, 74),
        _bits(v2, 50, 62),
        _bits(v2, 38, 50),
        _bits(v2, 36, 38),
        _bits(v2, 34, 36),
        _bits(v2, 32, 34),
        _bits(v2, 30, 32),
        _bits(v2, 28, 30),
        _bits(v2, 26, 28),
        _bits(v2, 24, 26),
        _bits(v2, 22, 24),
    ]
    for c, val in enumerate(vals2):
        witness[c][r2] = val
    r3 = row + 3
    vals3 = [
        _bits(v2, 20, 22),
        _bits(v2, 18, 20),
        _bits(v2, 16, 18),
        _bits(v0, 76, 88),
        _bits(v0, 64, 76),
        _bits(v1, 76, 88),
        _bits(v1, 64, 76),
        _bits(v2, 14, 16),
        _bits(v2, 12, 14),
        _bits(v2, 10, 12),
        _bits(v2, 8, 10),
        _bits(v2, 6, 8),
        _bits(v2, 4, 6),
        _bits(v2, 2, 4),
        _bits(v2, 0, 2),
    ]
    for c, val in enumerate(vals3):
        witness[c][r3] = val


def num_xors(bits: int) -> int:
    return -(-bits // 16)


def create_xor_gadget(start_row: int, bits: int = 64) -> list[CircuitGate]:
    gates = [
        CircuitGate(GateType.Xor16, new_wires(start_row + i), [])
        for i in range(num_xors(bits))
    ]
    gates.append(CircuitGate.zero(start_row + num_xors(bits)))
    return gates


def xor_witness(
    witness: list[list[int]], row: int, in1: int, in2: int, bits: int = 64
) -> int:
    out = in1 ^ in2
    for chunk in range(num_xors(bits)):
        r = row + chunk
        s = 16 * chunk
        a, b, o = in1 >> s, in2 >> s, out >> s
        # layout: cols 3-6 in1 nybbles, 7-10 in2, 11-14 out
        row_vals = [a, b, o]
        row_vals += [_bits(a, 0, 4), _bits(a, 4, 8), _bits(a, 8, 12), _bits(a, 12, 16)]
        row_vals += [_bits(b, 0, 4), _bits(b, 4, 8), _bits(b, 8, 12), _bits(b, 12, 16)]
        row_vals += [_bits(o, 0, 4), _bits(o, 4, 8), _bits(o, 8, 12), _bits(o, 12, 16)]
        for c, val in enumerate(row_vals):
            witness[c][r] = val
    # terminating zero row is already zero
    return out


def create_rot64_gadget(start_row: int, rot: int, f: FieldParams) -> list[CircuitGate]:
    gates = [
        CircuitGate(GateType.Rot64, new_wires(start_row), [pow(2, rot, f.p)]),
        CircuitGate(GateType.RangeCheck0, new_wires(start_row + 1), [0]),
        CircuitGate(GateType.RangeCheck0, new_wires(start_row + 2), [0]),
    ]
    # connect excess (row 0 col 2) with the second RangeCheck0's value cell
    connect_cell_pair(gates, (0, 2), (2, 0))
    return gates


def rot64_witness(
    witness: list[list[int]], row: int, word: int, rot: int
) -> int:
    """rot.rs:311-360: rotated = (word << rot | word >> (64-rot)) mod 2^64."""
    word &= (1 << 64) - 1
    rotated = ((word << rot) | (word >> (64 - rot))) & ((1 << 64) - 1) if rot else word
    excess = word >> (64 - rot) if rot else 0
    shifted = (word << rot) & ((1 << 64) - 1)
    bound = excess - (1 << rot) + (1 << 64)
    # bound occupies the limb/crumb columns of the Rot64 row (cols 3..14)
    row_vals = [word, rotated, excess]
    rc = _rc0_row_values(bound)
    row_vals += rc[3:]
    for c, val in enumerate(row_vals):
        witness[c][row] = val
    for c, val in enumerate(_rc0_row_values(shifted)):
        witness[c][row + 1] = val
    for c, val in enumerate(_rc0_row_values(excess)):
        witness[c][row + 2] = val
    return rotated


# ---------------------------------------------------------------------------
# Foreign field gadgets (foreign_field_add/{gadget,witness}.rs,
# foreign_field_mul/{gadget,witness}.rs). Values are 3x88-bit limbs of
# elements of a foreign modulus fm < 2^259.
# ---------------------------------------------------------------------------


def ff_limbs(v: int) -> list[int]:
    return [_bits(v, 0, 88), _bits(v, 88, 176), _bits(v, 176, 264)]


def create_ffadd_gadget(
    start_row: int, f: FieldParams, foreign_modulus: int, signs: list[int]
) -> list[CircuitGate]:
    """Chain of len(signs) additions/subtractions + final bound addition
    + Zero result row (gadget.rs:50-110). Each row's left input is the
    previous row's result (cols 0-2 of the row below)."""
    fm = ff_limbs(foreign_modulus)
    gates = []
    for i, s in enumerate(signs):
        gates.append(
            CircuitGate(
                GateType.ForeignFieldAdd,
                new_wires(start_row + i),
                fm + [s % f.p],
            )
        )
    # bound addition: result + 2^264 - fm (sign +1, overflow forced 1)
    gates.append(
        CircuitGate(GateType.ForeignFieldAdd, new_wires(start_row + len(signs)), fm + [1])
    )
    gates.append(CircuitGate.zero(start_row + len(signs) + 1))
    return gates


def _ffadd_fill_row(witness, row, al, bl, s, ovf, fml, p):
    """One FFAdd row; returns (result int, its limbs) written to row+1."""
    a = al[0] + (al[1] << 88) + (al[2] << 176)
    b = bl[0] + (bl[1] << 88) + (bl[2] << 176)
    fm = fml[0] + (fml[1] << 88) + (fml[2] << 176)
    res = a + s * b - ovf * fm
    assert 0 <= res < 1 << 264, "foreign field add out of range"
    rl = ff_limbs(res)
    bot = (
        (al[0] + (al[1] << 88))
        + s * (bl[0] + (bl[1] << 88))
        - ovf * (fml[0] + (fml[1] << 88))
        - (rl[0] + (rl[1] << 88))
    )
    carry, rem = divmod(bot, 1 << 176)
    assert rem == 0 and carry in (-1, 0, 1)
    for c, v in enumerate(al):
        witness[c][row] = v
    for c, v in enumerate(bl):
        witness[3 + c][row] = v
    witness[6][row] = ovf % p
    witness[7][row] = carry % p
    for c, v in enumerate(rl):
        witness[c][row + 1] = v
    return res, rl


def ffadd_witness(
    witness: list[list[int]],
    row: int,
    inputs: list[int],
    signs: list[int],
    foreign_modulus: int,
    p: int,
) -> tuple[int, int]:
    """witness.rs: chained adds then the bound addition. Returns
    (result, bound) where bound = result + 2^264 - fm must be
    multi-range-checked for full soundness."""
    fm = foreign_modulus
    fml = ff_limbs(fm)
    acc = inputs[0]
    al = ff_limbs(acc)
    r = row
    for b, s in zip(inputs[1:], signs):
        raw = acc + s * b
        ovf = s if (raw >= fm if s == 1 else raw < 0) else 0
        acc, al = _ffadd_fill_row(witness, r, al, ff_limbs(b), s, ovf, fml, p)
        r += 1
    bound, _ = _ffadd_fill_row(witness, r, al, [0, 0, 1 << 88], 1, 1, fml, p)
    return acc, bound


def create_ffmul_gadget(
    start_row: int, f: FieldParams, foreign_modulus: int
) -> list[CircuitGate]:
    """FFMul row + Zero row. Coeffs: [fm_hi, neg_fm limbs] where
    neg_fm = 2^264 - fm (circuitgates.rs:195). External multi-range
    checks of a, b, q, r and the carry/bound cells complete soundness."""
    negl = ff_limbs((1 << 264) - foreign_modulus)
    gates = [
        CircuitGate(
            GateType.ForeignFieldMul,
            new_wires(start_row),
            [_bits(foreign_modulus, 176, 264)] + negl,
        ),
        CircuitGate.zero(start_row + 1),
    ]
    return gates


def ffmul_witness(
    witness: list[list[int]], row: int, a: int, b: int, foreign_modulus: int, p: int
) -> tuple[int, int]:
    """foreign_field_mul/witness.rs: fill the 2-row FFMul gadget.
    Returns (quotient, remainder) with a*b = q*fm + r."""
    fm = foreign_modulus
    q, r = divmod(a * b, fm)
    al, bl, ql, rl = ff_limbs(a), ff_limbs(b), ff_limbs(q), ff_limbs(r)
    negl = ff_limbs((1 << 264) - fm)
    p0 = al[0] * bl[0] + ql[0] * negl[0]
    p1 = al[0] * bl[1] + al[1] * bl[0] + ql[0] * negl[1] + ql[1] * negl[0]
    p2 = (
        al[0] * bl[2]
        + al[2] * bl[0]
        + al[1] * bl[1]
        + ql[0] * negl[2]
        + ql[2] * negl[0]
        + ql[1] * negl[1]
    )
    p1_lo = p1 & ((1 << 88) - 1)
    p1_hi = p1 >> 88
    p1_hi_0 = p1_hi & ((1 << 88) - 1)
    p1_hi_1 = p1_hi >> 88
    r01 = rl[0] + (rl[1] << 88)
    carry0, rem = divmod(p0 + (p1_lo << 88) - r01, 1 << 176)
    assert rem == 0 and 0 <= carry0 < 4
    carry1, rem = divmod(p2 + p1_hi + carry0 - rl[2], 1 << 88)
    assert rem == 0 and 0 <= carry1 < 1 << 91
    q_hi_bound = ql[2] + (1 << 88) - _bits(fm, 176, 264) - 1

    cur = [0] * 15
    cur[0:3] = al
    cur[3:6] = bl
    cur[6] = p1_lo
    for k in range(4):
        cur[7 + k] = (carry1 >> (12 * k)) & 0xFFF
    cur[11] = (carry1 >> 84) & 3
    cur[12] = (carry1 >> 86) & 3
    cur[13] = (carry1 >> 88) & 3
    cur[14] = (carry1 >> 90) & 1
    nxt = [0] * 15
    nxt[0] = r01
    nxt[1] = rl[2]
    nxt[2:5] = ql
    nxt[5] = q_hi_bound
    nxt[6] = p1_hi_0
    nxt[7] = p1_hi_1
    for k in range(3):
        nxt[8 + k] = (carry1 >> (48 + 12 * k)) & 0xFFF
    nxt[11] = carry0
    for c in range(15):
        witness[c][row] = cur[c] % p
        witness[c][row + 1] = nxt[c] % p
    return q, r


# ---------------------------------------------------------------------------
# AND / NOT gadgets (and.rs:75-140, not.rs:60-160): compositions of the
# Xor16 gadget and double-generic rows.
# ---------------------------------------------------------------------------


def create_and_gadget(start_row: int, f: FieldParams, bits: int = 64) -> list[CircuitGate]:
    """and(a,b) = (a + b - xor(a,b)) / 2. Xor gadget rows followed by one
    double-generic row: g1 a+b-sum=0, g2 sum-xor-2*and=0 (and.rs:96-139)."""
    from ..builders import GenericGateSpec, create_generic_gadget

    gates = create_xor_gadget(start_row, bits)
    grow = start_row + len(gates)
    g1 = GenericGateSpec([1, 1, (-1) % f.p, 0, 0])
    g2 = GenericGateSpec([1, (-1) % f.p, (-2) % f.p, 0, 0])
    gates.append(create_generic_gadget(f, grow, g1, g2))
    gi = len(gates) - 1
    connect_cell_pair(gates, (0, 0), (gi, 0))  # a
    connect_cell_pair(gates, (0, 1), (gi, 1))  # b
    connect_cell_pair(gates, (0, 2), (gi, 4))  # xor
    connect_cell_pair(gates, (gi, 2), (gi, 3))  # sum
    return gates


def and_witness(
    witness: list[list[int]], row: int, in1: int, in2: int, bits: int = 64
) -> int:
    out_xor = xor_witness(witness, row, in1, in2, bits)
    grow = row + num_xors(bits) + 1
    s = in1 + in2
    out_and = in1 & in2
    vals = [in1, in2, s, s, out_xor, out_and]
    for c, v in enumerate(vals):
        witness[c][grow] = v
    return out_and


def create_not_gadget(start_row: int, f: FieldParams, count: int, bits: int = 64):
    """not(a) = 2^bits - 1 - a via generic gates, two values per double
    row (not.rs:119-160). Returns gates; value cells are col 0 (and col 3
    for the second value of each row)."""
    from ..builders import GenericGateSpec, create_generic_gadget

    allones = ((1 << bits) - 1) % f.p
    gates = []
    for i in range(0, count, 2):
        g1 = GenericGateSpec([(-1) % f.p, 0, (-1) % f.p, 0, allones])
        g2 = (
            GenericGateSpec([(-1) % f.p, 0, (-1) % f.p, 0, allones])
            if i + 1 < count
            else None
        )
        gates.append(create_generic_gadget(f, start_row + i // 2, g1, g2))
    return gates


def not_witness(
    witness: list[list[int]], row: int, values: list[int], bits: int = 64
) -> list[int]:
    outs = []
    for i, v in enumerate(values):
        r = row + i // 2
        base = 0 if i % 2 == 0 else 3
        nv = ((1 << bits) - 1) ^ v
        witness[base + 0][r] = v
        witness[base + 2][r] = nv
        outs.append(nv)
    return outs
