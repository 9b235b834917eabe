"""K8 (combine_windows) on the CPU: the CUDA kernel's design (csrc/k8_combine.cuh)
modelled in int64 torch and held exactly against the plain versions, the
host curve and the JAX package, on Vesta and Pallas.

- The level schedule of the doubling (3 levels: 3, 3, 1 products) and the
  complete add (5 levels: 3, 4, 4, 3, 2), against ec_double16 and ec_add16.
- The Horner chain as the kernel runs it (start from the top window, the
  add's doubling fallback looping back to the doubling), on chip_smoke.py's
  K8 edge windows (identity columns, the doubling and infinity fallbacks,
  mid-chain too), against the plain combine_windows, host Horner and the JAX
  package's msm._combine_windows_body, all exact (the JAX XLA branch starts
  from another encoding of infinity than the Pallas kernel; see the test).
The kernel itself: tests/test_torch_cuda.py, and its source on the host
against an emulated warp: tests/test_torch_k8_host.py."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.ops import msm as jmsm
from proof_systems_tpu.ops.curve_ops import JPoint as JJPoint
from proof_systems_tpu.ops.curve_ops import device_curve as jdevice_curve
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.ops import kernels
from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve

torch.set_num_threads(1)

CURVES = {"Vesta": (Vesta, JVesta), "Pallas": (Pallas, JPallas)}


class Levels:
    """The plain products of one level at a time, recording each width."""

    def __init__(self, P):
        self.P = P
        self.widths: list[int] = []

    def __call__(self, *pairs):
        self.widths.append(len(pairs))
        return kernels._muls(self.P, *pairs)


def double_by_levels(lv, p):
    """k8_double: {X^2, Y^2, YZ} -> {B^2, (X + B)^2, E^2} -> E (D - X3)."""
    P, (x, y, z) = lv.P, p
    add, sub = (lambda a, b: kernels.add16(P, a, b)), (lambda a, b: kernels.sub16(P, a, b))
    a, b, yz = lv((x, x), (y, y), (y, z))
    xb = add(x, b)
    e = add(add(a, a), a)
    c, xb2, f = lv((b, b), (xb, xb), (e, e))
    d = sub(sub(xb2, a), c)
    d = add(d, d)
    x3 = sub(f, add(d, d))
    c8 = add(c, c)
    c8 = add(c8, c8)
    c8 = add(c8, c8)
    (t,) = lv((e, sub(d, x3)))
    return x3, sub(t, c8), add(yz, yz)


def add_by_levels(lv, p, q):
    """k8_add_pts on a batch of columns: the result and, per column, whether
    the doubling fallback applies (the kernel then doubles p)."""
    P, (x1, y1, z1), (x2, y2, z2) = lv.P, p, q
    add, sub = (lambda a, b: kernels.add16(P, a, b)), (lambda a, b: kernels.sub16(P, a, b))
    p_inf, q_inf = kernels.is_zero16(z1), kernels.is_zero16(z2)
    zs = add(z1, z2)
    z1z1, z2z2, zs2 = lv((z1, z1), (z2, z2), (zs, zs))
    u1, u2, t2, t1 = lv((x1, z2z2), (x2, z1z1), (z2, z2z2), (z1, z1z1))
    h = sub(u2, u1)
    h2 = add(h, h)
    zz = sub(sub(zs2, z1z1), z2z2)
    s1, s2, i, z3 = lv((y1, t2), (y2, t1), (h2, h2), (zz, h))
    rr = sub(s2, s1)
    r2 = add(rr, rr)
    h_zero, r_zero = kernels.is_zero16(h), kernels.is_zero16(r2)
    j, v, r2sq = lv((h, i), (u1, i), (r2, r2))
    x3 = sub(sub(r2sq, j), add(v, v))
    s1j, t = lv((s1, j), (r2, sub(v, x3)))
    out = (x3, sub(t, add(s1j, s1j)), kernels._sel(h_zero, torch.zeros_like(z3), z3))
    out = tuple(kernels._sel(p_inf, b, a) for a, b in zip(out, q))
    out = tuple(kernels._sel(q_inf, b, a) for a, b in zip(out, p))
    return out, h_zero & r_zero & ~p_inf & ~q_inf


def combine_by_levels(P, c: int, win):
    """k8_combine_column on every column at once: the top window (the
    identity where it is infinite), then c doublings and an add a window,
    where the add's doubling fallback doubles the accumulator instead."""
    lv = Levels(P)
    W = win[0].shape[1]
    top = tuple(t[:, W - 1] for t in win)
    acc = tuple(kernels._sel(kernels.is_zero16(top[2]), torch.zeros_like(t), t) for t in top)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = double_by_levels(lv, acc)
        out, redo = add_by_levels(lv, acc, tuple(t[:, w] for t in win))
        if bool(redo.any()):
            out = tuple(kernels._sel(redo, d, o) for d, o in zip(double_by_levels(lv, acc), out))
        acc = out
    return acc, lv.widths


def _points16(curve, dc, rng, n, inf):
    """Random general Jacobian points (z != R), at infinity at `inf`."""
    pts = [curve.scalar_mul(rng.randrange(1, curve.scalar.p), curve.generator) for _ in range(n)]
    for i in inf:
        pts[i] = None
    J = dc.double(dc.to_jacobian(dc.pack_affine(pts, device="cpu")))
    return tuple(kernels.to16(t) for t in J)


@pytest.mark.parametrize("name", CURVES)
def test_level_schedule_matches_plain_formulas(name):
    """Three levels of 3, 3 and 1 products a doubling, five of 3, 4, 4, 3 and
    2 an add (26 levels a Horner step at c = 7; no level wider than the
    kernel's four lanes), equal to ec_double16 and
    ec_add16 limb for limb, on random points, infinities on either side and
    both, P + P (columns 20, 21) and P + (-P) (22, 23)."""
    curve = CURVES[name][0]
    rng = random.Random(810 + list(CURVES).index(name))
    dc = device_curve(curve)
    P = kernels.field16(dc.F, "cpu")
    p = _points16(curve, dc, rng, 24, inf=(1, 5))
    q = _points16(curve, dc, rng, 24, inf=(2, 5))
    neg_y = kernels.sub16(P, torch.zeros_like(p[1][:, 22:]), p[1][:, 22:])
    q = (torch.cat([q[0][:, :20], p[0][:, 20:]], dim=1),
         torch.cat([q[1][:, :20], p[1][:, 20:22], neg_y], dim=1),
         torch.cat([q[2][:, :20], p[2][:, 20:]], dim=1))
    lv = Levels(P)
    dbl = double_by_levels(lv, p)
    assert lv.widths == [3, 3, 1]
    for a, b in zip(dbl, kernels.ec_double16(P, p)):
        assert torch.equal(a, b)
    lv = Levels(P)
    out, redo = add_by_levels(lv, p, q)
    assert lv.widths == [3, 4, 4, 3, 2]
    want = kernels.ec_add16(P, p, q)
    assert redo.tolist() == [False] * 20 + [True, True, False, False]
    for a, b, d in zip(out, want, kernels.ec_double16(P, p)):
        assert torch.equal(kernels._sel(redo, d, a), b)
    assert chip_smoke.k8_chain(37, 7) == (36 * (7 * 7 + 16), 36 * 26)


@pytest.mark.parametrize("W,b,c", chip_smoke.K8_EDGE_SHAPES)
@pytest.mark.parametrize("name", CURVES)
def test_combine_by_levels_on_edge_windows(name, W, b, c):
    """The kernel's chain on chip_smoke.py's K8 edge rows equals the plain
    combine_windows limb for limb, and host Horner as points; at the
    fallback shape also the JAX package's _combine_windows_body."""
    curve, jcurve = CURVES[name]
    rng = random.Random(820 + W * b * c + list(CURVES).index(name))
    dc = device_curve(curve)
    wins = chip_smoke.k8_windows(curve, dc, rng, W, b, c, "cpu")
    P = kernels.field16(dc.F, "cpu")
    got, widths = combine_by_levels(P, c, tuple(kernels.to16(t) for t in wins))
    got = tuple(kernels.from16(t.contiguous()) for t in got)
    plain = kernels.combine_windows(dc.F, c, *wins)
    for a, e in zip(got, plain):
        assert torch.equal(a, e)
    assert sum(widths) >= (W - 1) * (7 * c + 16)

    host_wins = dc.unpack_jacobian(JPoint(*(t.reshape(8, W * b) for t in wins)))
    host = []
    for col in range(b):
        acc = None
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                acc = curve.double(acc)
            acc = curve.add(acc, host_wins[w * b + col])
        host.append(acc)
    assert dc.unpack_jacobian(JPoint(*got)) == host
    if W >= 3:  # the fallback columns exist: the doubling at column 1 and 3
        assert host[0] is None and host[1] is not None

    if (W, b, c) == chip_smoke.K8_EDGE_SHAPES[0]:
        # The JAX package's XLA branch starts its chain from inf_jacobian,
        # (R, R, 0) (msm.py:165); the Pallas kernel that K8 replaces starts
        # from (0, 0, 0) (pallas_field.py:605-607). The limbs differ only
        # in a column whose windows are all infinite (column 0), where both
        # are the point at infinity and K8 keeps the Pallas kernel's zeros.
        jdc = jdevice_curve(jcurve)
        jwins = JJPoint(*(jnp.asarray(convert.limbs_to_numpy(t)) for t in wins))
        want = jmsm._combine_windows_body(jdc, c, jwins)
        for ours, theirs in zip(got, want):
            ours, theirs = convert.limbs_to_numpy(ours), np.asarray(theirs)
            assert np.array_equal(ours[:, 1:], theirs[:, 1:])
            assert not ours[:, 0].any()
        assert not np.asarray(want[2])[:, 0].any()
