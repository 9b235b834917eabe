"""Radix-2 NTT over the Pasta fields (device, batched).

Counterpart of proof_systems_tpu/ops/ntt.py, with the same semantics as
arkworks' `Radix2EvaluationDomain`: a domain of size n = 2^k generated by
TWO_ADIC_ROOT_OF_UNITY^(2^(32-k)); `ntt(coeffs)[i] = f(g^i)` with both
sides in natural order; `intt` is the exact inverse (scales by n^-1).

The network is the JAX package's constant-geometry (Pease) form: every
stage does u = a + b, v = (a - b) * tw_s, interleave(u, v), with
tw_s[i] = w^((i >> s) << s), and one final bit-reversal gather. Here the
stages are a Python loop; the twiddle products run in K1 (mont_mul), the
additions are torch ops. Leading batch axes transform many polynomials at
once (the prover's 15 witness columns).
"""

from __future__ import annotations

import functools

import torch

from ..fields import FieldParams
from ..runtime import resolve_device
from . import limb
from .limb import NLIMBS, DeviceField, device_field


def _bit_reverse_indices(log_n: int) -> torch.Tensor:
    idx = torch.arange(1 << log_n)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


class NttPlan:
    """Twiddle tables and permutation for one (field, log_n, device)."""

    def __init__(self, field: FieldParams, log_n: int, device: torch.device):
        if log_n > field.two_adicity:
            raise ValueError(f"domain 2^{log_n} exceeds 2-adicity of {field.name}")
        self.field = field
        self.log_n = log_n
        self.n = 1 << log_n
        self.device = device
        self.F: DeviceField = device_field(field)
        self.group_gen = field.root_of_unity(log_n)
        self.group_gen_inv = field.inv(self.group_gen) if log_n > 0 else 1
        self.n_inv = field.inv(self.n)
        self.bitrev = _bit_reverse_indices(log_n).to(device)
        self.fwd_twiddles = self._stage_twiddles(self.group_gen)
        self.inv_twiddles = self._stage_twiddles(self.group_gen_inv)
        self.n_inv_mont = self.F.const_mont(self.n_inv, (1,), device=device)

    def _stage_twiddles(self, g: int) -> torch.Tensor:
        """(log_n, 8, n/2) Montgomery table: tw[s][i] = g^((i >> s) << s).

        The n/2 powers of g are made once on the host and converted on the
        device; each stage's row is a gather of them."""
        p = self.field.p
        half = max(self.n // 2, 1)
        pw = [1] * half
        for i in range(1, half):
            pw[i] = pw[i - 1] * g % p
        pw_dev = self.F.pack_mont(pw, device=self.device)
        i = torch.arange(half, device=self.device)
        rows = [pw_dev[:, (i >> s) << s] for s in range(self.log_n)]
        if not rows:
            return torch.zeros((0, NLIMBS, half), dtype=torch.int32, device=self.device)
        return torch.stack(rows)

    def _transform(self, x: torch.Tensor, twiddles: torch.Tensor) -> torch.Tensor:
        if x.device.type != self.device.type:
            raise ValueError(f"input on {x.device}, plan on {self.device}")
        if x.shape[-1] != self.n:
            raise ValueError(f"last axis must be {self.n}, got {x.shape[-1]}")
        F = self.F
        n, half = self.n, self.n // 2
        batch_ndim = x.dim() - 2
        for s in range(self.log_n):
            a, b = x[..., :half], x[..., half:]
            u = limb.add(F, a, b)
            tw = twiddles[s].reshape(NLIMBS, *(1,) * batch_ndim, half)
            v = limb.mont_mul(F, limb.sub(F, a, b), tw)
            x = torch.stack([u, v], dim=-1).reshape(*u.shape[:-1], n)
        return x[..., self.bitrev]

    def ntt_t(self, coeffs: torch.Tensor, fwd_twiddles: torch.Tensor) -> torch.Tensor:
        """coeffs (8, ..., n) Montgomery -> evaluations at g^0 .. g^(n-1)."""
        return self._transform(coeffs, fwd_twiddles)

    def intt_t(self, evals: torch.Tensor, inv_twiddles: torch.Tensor) -> torch.Tensor:
        """evals (8, ..., n) Montgomery -> coefficients."""
        x = self._transform(evals, inv_twiddles)
        scale = self.n_inv_mont.reshape(NLIMBS, *(1,) * (x.dim() - 2), 1)
        return limb.mont_mul(self.F, x, scale)

    def ntt(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self.ntt_t(coeffs, self.fwd_twiddles)

    def intt(self, evals: torch.Tensor) -> torch.Tensor:
        return self.intt_t(evals, self.inv_twiddles)


def sum_mod(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Modular sum along the last axis by a halving tree of field adds.

    a: (8, ..., n) with n a power of two. Returns (8, ..., 1)."""
    n = a.shape[-1]
    if n & (n - 1):
        raise ValueError(f"sum_mod needs a power-of-two length, got {n}")
    while n > 1:
        n //= 2
        a = limb.add(F, a[..., :n], a[..., n:])
    return a


def dot_mod(F: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over the field along the last (power-of-two) axis."""
    return sum_mod(F, limb.mont_mul(F, a, b))


@functools.lru_cache(maxsize=None)
def _plan(field: FieldParams, log_n: int, device: torch.device) -> NttPlan:
    return NttPlan(field, log_n, device)


def ntt_plan(field: FieldParams, log_n: int, device=None) -> NttPlan:
    """Cached plan on `device` (the CUDA card unless device="cpu")."""
    return _plan(field, log_n, resolve_device(device))
