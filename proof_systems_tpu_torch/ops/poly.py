"""Device polynomial helpers: powers, point evaluation, exact divisions.

Counterpart of proof_systems_tpu/ops/poly.py:
  - a polynomial is evaluated as the dot product of its coefficients with
    the power vector of the point (K1 products, a halving tree of adds);
  - division by the vanishing polynomial x^n - 1 is block suffix sums
    (torch ops);
  - division by a linear factor x - c is the recurrence
    s_j = f_(L-1-j) + c s_(j-1) over the reversed coefficients, one launch
    of K9 (kernels.linear_scan), whose plain version runs on the CPU.
"""

from __future__ import annotations

import torch

from . import kernels, limb, ntt
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


def divide_by_vanishing(F: DeviceField, coeffs: torch.Tensor, n: int):
    """f / (x^n - 1) for deg f < 8n: returns (quotient (8, ..., 7n),
    remainder (8, ..., n)). Quotient block i = sum of blocks j > i; the
    remainder is the sum of all blocks."""
    L = coeffs.shape[-1]
    total = -(-L // n) * n
    if total != L:
        coeffs = torch.nn.functional.pad(coeffs, (0, total - L))
    nblocks = total // n
    blocks = [coeffs[..., i * n : (i + 1) * n] for i in range(nblocks)]
    suffix = [None] * nblocks
    acc = blocks[-1]
    for i in range(nblocks - 2, -1, -1):
        suffix[i] = acc  # sum over j > i
        acc = limb.add(F, acc, blocks[i])
    if nblocks == 1:
        return coeffs[..., :0], acc
    return torch.cat(suffix[: nblocks - 1], dim=-1), acc


def divide_by_linear_dev(F: DeviceField, coeffs: torch.Tensor, c: int):
    """f / (x - c) with the remainder left on the device (the reference's
    prover._divide_by_linear_dev): returns (quotient (8, ..., L-1),
    remainder f(c) (8, ..., 1)). vs[i] = s_(L-1-i), so q_k = vs[L-2-k]."""
    L = coeffs.shape[-1]
    vs = kernels.linear_scan(F, coeffs.flip(-1).contiguous(), c)
    return vs[..., : L - 1].flip(-1), vs[..., L - 1 : L]


def divide_by_linear(F: DeviceField, coeffs: torch.Tensor, c: int):
    """f / (x - c): returns (quotient (8, L-1), remainder as a host int)."""
    q, rem = divide_by_linear_dev(F, coeffs, c)
    return q, F.unpack_mont(rem)[0]
