"""Device polynomial helpers: power vectors and evaluation at points.

Counterpart of the evaluation half of proof_systems_tpu/ops/poly.py
(`powers_dev`, `_pad_pow2`, `eval_at`, `eval_at2`): a polynomial is
evaluated as the dot product of its coefficients with the power vector of
the point (K1 products, a halving tree of field adds).
"""

from __future__ import annotations

import torch

from . import limb, ntt
from .limb import DeviceField


def powers_dev(F: DeviceField, x: int, n: int, *, device) -> torch.Tensor:
    """[1, x, .., x^(n-1)] as an (8, n) Montgomery tensor on `device`, by
    doubling: one copy from the host, then a squaring chain on the device."""
    arr = F.one_mont((1,), device=device)
    if n <= 1:
        return arr[:, :n].clone()
    step = F.pack_mont([x], shape=(1,), device=device)  # x^length, length = 1
    length = 1
    while length < n:
        arr = torch.cat([arr, limb.mont_mul(F, arr, step)], dim=-1)
        length *= 2
        if length < n:
            step = limb.mont_sqr(F, step)
    return arr[:, :n]


def _pad_pow2(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m == n:
        return a
    return torch.cat([a, a.new_zeros((*a.shape[:-1], m - n))], dim=-1)


def eval_at(F: DeviceField, coeffs: torch.Tensor, powers: torch.Tensor) -> list[int]:
    """Evaluate (8, b, L) Montgomery coefficient rows at the point whose
    (8, L) power vector is given. Returns b host ints."""
    prod = limb.mont_mul(F, coeffs, powers[:, None, :] if powers.dim() == 2 else powers)
    return F.unpack_mont(ntt.sum_mod(F, _pad_pow2(prod)))


def eval_at2(F: DeviceField, coeffs: torch.Tensor, pow_a: torch.Tensor, pow_b: torch.Tensor):
    """Evaluate (8, b, L) rows at two points with one reduction and one
    fetch from the device. Returns (evals_a, evals_b) as host int lists."""
    pows = torch.stack([pow_a, pow_b], dim=1)  # (8, 2, L)
    prod = limb.mont_mul(F, coeffs[:, None], pows[:, :, None, :])  # (8, 2, b, L)
    flat = F.unpack_mont(ntt.sum_mod(F, _pad_pow2(prod)))
    b = coeffs.shape[1]
    return flat[:b], flat[b:]
