"""Batched Pasta curve arithmetic on device (Jacobian and affine forms).

Counterpart of proof_systems_tpu/ops/curve_ops.py. The group law runs in
the hand-written kernels K2 (complete add) and K3 (doubling), and the IPA's
endo ladder in one kernel of its own; to_affine goes through the field
layer (K1, K4, K5).

Formulas (a = 0 short Weierstrass, y^2 = x^3 + 5): dbl-2009-l and
add-2007-bl with the doubling, negation and infinity fallbacks of the JAX
package, so results match its `add_xla`/`double_xla` limb for limb.

Host golden model: proof_systems_tpu_torch.curves (exact affine ints).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..curves import CurveParams
from . import kernels, limb
from .limb import DeviceField, device_field


class JPoint(NamedTuple):
    """Jacobian points (x : y : z), z == 0 <=> infinity. Montgomery coords."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class APoint(NamedTuple):
    """Affine points with an explicit infinity mask. Montgomery coords."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool, batch shape


def stack_points(points, dim: int) -> JPoint:
    return JPoint(*(torch.stack([getattr(p, k) for p in points], dim=dim) for k in "xyz"))


def map_points(fn, p: JPoint) -> JPoint:
    return JPoint(fn(p.x), fn(p.y), fn(p.z))


class DeviceCurve:
    """Device context for one Pasta curve (field context + group law)."""

    def __init__(self, curve: CurveParams):
        self.params = curve
        self.F: DeviceField = device_field(curve.base)
        self.scalar_F: DeviceField = device_field(curve.scalar)

    # -- host conversion ---------------------------------------------------

    def pack_affine(self, pts, *, device) -> APoint:
        """Host affine points ((x, y) | None) -> APoint batch on `device`."""
        xs = [0 if p is None else p[0] for p in pts]
        ys = [0 if p is None else p[1] for p in pts]
        inf = torch.tensor([p is None for p in pts], dtype=torch.bool, device=device)
        return APoint(
            self.F.pack_mont(xs, device=device), self.F.pack_mont(ys, device=device), inf
        )

    def unpack_affine(self, a: APoint) -> list:
        xs = self.F.unpack_mont(a.x)
        ys = self.F.unpack_mont(a.y)
        infs = a.inf.detach().cpu().numpy().reshape(-1)
        return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]

    def unpack_jacobian(self, p: JPoint) -> list:
        return self.unpack_affine(self.to_affine(p))

    # -- conversions -------------------------------------------------------

    def to_jacobian(self, a: APoint) -> JPoint:
        F = self.F
        one = F.one_mont(a.inf.shape, device=a.x.device)
        z = limb.select(a.inf, F.zeros(a.inf.shape, device=a.x.device), one)
        return JPoint(a.x, a.y, z)

    def to_affine(self, p: JPoint) -> APoint:
        """Normalize via a shared batch inversion of z when the batch size
        is a power of two (K5 + K4), else an elementwise inverse (K4)."""
        F = self.F
        inf = limb.is_zero(F, p.z)
        m = p.z[0].numel()
        if m & (m - 1) == 0:
            zinv = limb.batch_inverse(F, p.z)
        else:
            zinv = limb.inv(F, p.z)
        zinv2 = limb.mont_sqr(F, zinv)
        zinv3 = limb.mont_mul(F, zinv2, zinv)
        return APoint(limb.mont_mul(F, p.x, zinv2), limb.mont_mul(F, p.y, zinv3), inf)

    # -- group law ---------------------------------------------------------

    def double(self, p: JPoint) -> JPoint:
        return JPoint(*kernels.jacobian_double(self.F, *map(torch.Tensor.contiguous, p)))

    def add(self, p: JPoint, q: JPoint) -> JPoint:
        """Complete addition: handles infinity, equal and negated lanes."""
        p = map_points(torch.Tensor.contiguous, p)
        q = map_points(torch.Tensor.contiguous, q)
        return JPoint(*kernels.jacobian_add(self.F, *p, *q))

    def add_mixed(self, p: JPoint, q: APoint) -> JPoint:
        """p + affine q (madd-2007-bl), complete through selects: the
        doubling lanes take K3, infinity on either side the other operand."""
        F = self.F
        p_inf = limb.is_zero(F, p.z)
        z1z1 = limb.mont_sqr(F, p.z)
        u2 = limb.mont_mul(F, q.x, z1z1)
        s2 = limb.mont_mul(F, q.y, limb.mont_mul(F, p.z, z1z1))
        h = limb.sub(F, u2, p.x)
        rr = limb.sub(F, s2, p.y)
        r2 = limb.add(F, rr, rr)
        h_zero = limb.is_zero(F, h)
        r_zero = limb.is_zero(F, r2)

        i = limb.mont_sqr(F, limb.add(F, h, h))
        j = limb.mont_mul(F, h, i)
        v = limb.mont_mul(F, p.x, i)
        x3 = limb.sub(F, limb.sub(F, limb.mont_sqr(F, r2), j), limb.add(F, v, v))
        s1j = limb.mont_mul(F, p.y, j)
        y3 = limb.sub(F, limb.mont_mul(F, r2, limb.sub(F, v, x3)), limb.add(F, s1j, s1j))
        zh = limb.mont_mul(F, p.z, h)
        z3 = limb.add(F, zh, zh)  # Z3 = (Z1+H)^2 - Z1Z1 - H^2 = 2 Z1 H
        dbl = self.double(p)
        use_dbl = h_zero & r_zero
        to_inf = h_zero & ~r_zero
        out = self.select(use_dbl, dbl, JPoint(x3, y3, z3))
        out = JPoint(out.x, out.y, limb.select(to_inf & ~p_inf, torch.zeros_like(z3), out.z))
        # p at infinity -> q (z = 1); q at infinity -> p
        one = F.one_mont(q.inf.shape, device=q.x.device)
        out = self.select(p_inf, JPoint(q.x, q.y, one), out)
        return self.select(q.inf, p, out)

    def endo_ladder(self, p: JPoint, bits: torch.Tensor) -> JPoint:
        """[u] p for the scalar challenge u of the 128 bits `bits` (the IPA
        fold step's 64-step endo ladder, one kernel); p has z in {0, R}."""
        p = map_points(torch.Tensor.contiguous, p)
        return JPoint(*kernels.endo_ladder(self.F, self.params.endos[0], *p, bits))

    def neg(self, p: JPoint) -> JPoint:
        return JPoint(p.x, limb.neg(self.F, p.y), p.z)

    def select(self, cond: torch.Tensor, t: JPoint, f: JPoint) -> JPoint:
        """t where cond else f; cond has the batch shape."""
        return JPoint(*(limb.select(cond, a, b) for a, b in zip(t, f)))

    def inf_jacobian(self, batch_shape=(), *, device) -> JPoint:
        F = self.F
        one = F.one_mont(batch_shape, device=device)
        return JPoint(one.clone(), one.clone(), F.zeros(batch_shape, device=device))

    # -- reductions --------------------------------------------------------

    def sum_points(self, p: JPoint) -> JPoint:
        """Tree-sum along the last batch axis (K2), padded with infinity to
        a power of two; the last axis keeps length 1."""
        n = p.x.shape[-1]
        m = 1 << max(n - 1, 0).bit_length()
        if m != n:
            pad = self.inf_jacobian((*p.x.shape[1:-1], m - n), device=p.x.device)
            p = JPoint(*(torch.cat([a, b], dim=-1) for a, b in zip(p, pad)))
        while m > 1:
            m //= 2
            p = self.add(JPoint(*(t[..., :m] for t in p)), JPoint(*(t[..., m:] for t in p)))
        return p


@functools.lru_cache(maxsize=None)
def device_curve(curve: CurveParams) -> DeviceCurve:
    return DeviceCurve(curve)


def scalar_mul_const(curve: DeviceCurve, scalar_std: torch.Tensor, p: JPoint) -> JPoint:
    """[k]P for ONE shared scalar across a batch of points.

    scalar_std: (8,) canonical standard-form limbs (not Montgomery) on the
    points' device, the port's 32-bit limbs where the JAX package takes 16
    of 16 bits. MSB-first double-and-add over a fixed 256 steps (K3, K2),
    the bit chosen by a select on the device, so the host never reads k."""
    words = scalar_std.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(limb.LIMB_BITS, device=words.device)
    bits = ((words[:, None] >> shifts) & 1).reshape(limb.NBITS) == 1  # LSB first
    acc = curve.inf_jacobian(p.x.shape[1:], device=p.x.device)
    for i in range(limb.NBITS - 1, -1, -1):
        acc = curve.double(acc)
        acc = curve.select(bits[i], curve.add(acc, p), acc)
    return acc
