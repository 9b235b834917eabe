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


@functools.lru_cache(maxsize=None)
def device_curve(curve: CurveParams) -> DeviceCurve:
    return DeviceCurve(curve)

