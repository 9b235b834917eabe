"""The plain versions' 16-bit limb arithmetic (ops/kernels.py) against
Python integers and against itself: the int64 field ops for narrow batches
(_Int16: add16, sub16 and whole 16 x 16 product tables) and the
float64 ones for wide batches (_Float16: float64 columns, REDC steps over
p's nonzero limbs, carries rippled limb by limb) give every lane's one
canonical value, for the Pasta primes (whose REDC step needs no division)
and for 2^255 - 19 (the general REDC step); and the complete add computes
only the lanes that keep its formula's value, once for each distinct pair
of operands, with the limbs of a lane-by-lane computation."""

import random

import pytest
import torch

from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.ops import kernels

torch.set_num_threads(1)

ED25519 = (1 << 255) - 19
PRIMES = {"Fp": Fp.p, "Fq": Fq.p, "2^255-19": ED25519}
R = 1 << 256


def _field(p: int):
    return kernels._field16(p, R % p, "cpu")


def _limbs(xs, shape=None) -> torch.Tensor:
    t = torch.tensor([kernels.limbs16(x) for x in xs], dtype=torch.int64).T.contiguous()
    return t if shape is None else t.reshape(16, *shape)


def _ints(t: torch.Tensor) -> list[int]:
    t = t.reshape(16, -1)
    return [sum(int(t[i, j]) << (16 * i) for i in range(16)) for j in range(t.shape[1])]


def _values(p: int, n: int, seed: int) -> list[int]:
    rng = random.Random(seed)
    edge = [0, 1, 2, p - 1, p - 2, R % p, (R * R) % p, (1 << 255) % p, (1 << 128) % p]
    return (edge + [rng.randrange(p) for _ in range(n)])[:n]


@pytest.mark.parametrize("name", sorted(PRIMES))
@pytest.mark.parametrize("n", [9, 100, 3000])
def test_field_ops_match_python(name, n):
    """add16, sub16, mul16 and _muls (on int64 limbs at 9 lanes, on float64
    ones at 100 and 3,000: kernels.FLOAT_LANES) and _Int16 / _Float16's add,
    sub, mul and muls, value for value."""
    p = PRIMES[name]
    P = _field(p)
    xs, ys = _values(p, n, 1), _values(p, n, 2)[::-1]
    a, b = _limbs(xs), _limbs(ys)
    rinv = pow(R, -1, p)
    want = {"add": [(x + y) % p for x, y in zip(xs, ys)],
            "sub": [(x - y) % p for x, y in zip(xs, ys)],
            "mul": [x * y * rinv % p for x, y in zip(xs, ys)],
            "sqr": [x * x * rinv % p for x in xs]}
    assert _ints(kernels.add16(P, a, b)) == want["add"]
    assert _ints(kernels.sub16(P, a, b)) == want["sub"]
    assert _ints(kernels.mul16(P, a, b)) == want["mul"]
    assert _ints(kernels.mul16(P, a, a)) == want["sqr"]
    m, s2, m2 = kernels._muls(P, (a, b), (a, a), (b, a))
    assert _ints(m) == _ints(m2) == want["mul"] and _ints(s2) == want["sqr"]
    for A in (kernels._Int16(P), kernels._Float16(P)):
        ea, eb = A.enter(a), A.enter(b)
        assert _ints(A.leave(A.add(ea, eb))) == want["add"], type(A)
        assert _ints(A.leave(A.sub(ea, eb))) == want["sub"], type(A)
        assert _ints(A.leave(A.mul(ea, eb))) == want["mul"], type(A)
        sq, ab = A.muls((ea, ea), (ea, eb))
        assert _ints(A.leave(sq)) == want["sqr"] and _ints(A.leave(ab)) == want["mul"], type(A)


def test_field16_refuses_wide_primes():
    with pytest.raises(ValueError, match="2\\^255"):
        kernels.Field16((1 << 256) - 189, 189, "cpu")


def _points(n: int, seed: int):
    """n Vesta points in Jacobian limbs (x, y, z) with z random, as the
    scans hold them: (X z^2, Y z^3, z) in Montgomery form."""
    from proof_systems_tpu_torch.curves import Vesta

    rng = random.Random(seed)
    p = Vesta.base.p
    g = Vesta.generator
    out = []
    for _ in range(n):
        pt = Vesta.scalar_mul(rng.randrange(1, 1 << 64), g)
        z = rng.randrange(1, p)
        out.append((pt[0] * z * z % p, pt[1] * z * z * z % p, z))
    mont = lambda v: v * R % p  # noqa: E731
    return tuple(_limbs([mont(c[k]) for c in out]) for k in range(3)), out


@pytest.mark.parametrize("lanes", [40, 1500])
def test_complete_add_lanes_match_lane_by_lane(lanes):
    """ec_add16 and ec_madd16 over a batch whose lanes hold the identity on
    either side, P + P (the doubling), P + (-P) (the identity) and repeated
    pairs (the operand dedup; the int64 ops at 40 lanes, the float64 ones at
    1,500) give each lane's limbs of the int64 formulas run on that lane
    alone."""
    from proof_systems_tpu_torch.curves import Vesta

    P = kernels._field16(Vesta.base.p, R % Vesta.base.p, "cpu")
    (x, y, z), _ = _points(24, 7)
    rng = random.Random(8)
    zero = torch.zeros_like(x[:, :1])
    neg_y = kernels.sub16(P, torch.zeros_like(y), y)
    pick_p, pick_q = [], []
    for j in range(lanes):
        i, k = rng.randrange(24), rng.randrange(24)
        kind = j % 6
        pick_p.append((i, False, kind == 0))
        pick_q.append({1: (i, False, False), 2: (i, True, False), 3: (k, False, True)}.get(
            kind, (k if kind == 4 else (i + 1) % 24, False, False)))

    def build(picks):
        cols = ([], [], [])
        for i, neg, inf in picks:
            for c, t in zip(cols, (x[:, i : i + 1], (neg_y if neg else y)[:, i : i + 1],
                                   zero if inf else z[:, i : i + 1])):
                c.append(t)
        return tuple(torch.cat(c, 1) for c in cols)

    p_pts, q_pts = build(pick_p), build(pick_q)
    for fn in (kernels.ec_add16, kernels.ec_madd16):
        got = fn(P, p_pts, q_pts)
        for j in range(0, lanes, max(1, lanes // 60)):
            one = fn(P, tuple(t[:, j : j + 1] for t in p_pts), tuple(t[:, j : j + 1] for t in q_pts))
            for g, o in zip(got, one):
                assert torch.equal(g[:, j : j + 1], o), (fn.__name__, j)


def test_float_and_int_formulas_agree():
    """The add, mixed add and doubling formulas over _Int16 and _Float16 on
    the same 200 lanes give the same limbs."""
    from proof_systems_tpu_torch.curves import Vesta

    P = kernels._field16(Vesta.base.p, R % Vesta.base.p, "cpu")
    p_pts, _ = _points(200, 9)
    q_pts = tuple(t.roll(1, 1) for t in p_pts)
    outs = []
    for A in (kernels._Int16(P), kernels._Float16(P)):
        ep, eq = (tuple(A.enter(t) for t in pt) for pt in (p_pts, q_pts))
        (x, y, z), h, r2 = kernels._add_main(A, ep, eq)
        (mx, my, mz), mh, mr = kernels._madd_main(A, ep, eq)
        outs.append([A.leave(t) for t in (x, y, z, h, r2, mx, my, mz, mh, mr,
                                           *kernels._double(A, ep))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
