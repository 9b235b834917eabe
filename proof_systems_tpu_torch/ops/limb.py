"""256-bit modular arithmetic on (8, ...) int32 limb tensors.

Counterpart of proof_systems_tpu/ops/limb.py. A field element is the
Montgomery integer x*R mod p (R = 2^256), the same integer as in the JAX
package; only the limb width differs. Here it is 8 limbs of 32 bits,
limb-major: an array of N elements has shape (8, N), so CUDA threads that
handle neighbouring elements read neighbouring words. The limbs are held in
int32 tensors (bit pattern of the uint32 limb): torch indexes, gathers and
sorts int32 on every device.

The Montgomery product, powers and prefix products run through the hand
written kernels (ops/kernels.py: K1, K4, K5 and K12). Addition, subtraction and the
selects are torch ops, as they were XLA ops in the JAX package; they compute
in int64 on 16-bit limbs (kernels.Field16).

Host golden model: proof_systems_tpu_torch.fields (exact Python ints).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..fields import FieldParams
from . import kernels
from .kernels import from16, to16

NLIMBS = 8
LIMB_BITS = 32
NBITS = NLIMBS * LIMB_BITS  # 256
R = 1 << NBITS


# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------


def int_to_words(x: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & 0xFFFFFFFF for i in range(NLIMBS)]


# Elements converted together by ints_to_limbs: a chunk whose values all fit
# in int64 (the small witness values of a trace) converts as one numpy
# array; the other elements of a chunk go through their bytes.
PACK_CHUNK = 1 << 16


def ints_to_limbs(xs: Sequence[int], shape=None, p: int | None = None) -> np.ndarray:
    """Ints in [0, 2^256) -> (8, len(xs)) int32 limbs (or (8, *shape)).
    With `p`, any ints, reduced mod p first."""
    xs = xs if isinstance(xs, list) else list(xs)
    out = np.zeros((NLIMBS, len(xs)), dtype=np.uint32)
    for lo in range(0, len(xs), PACK_CHUNK):
        part = xs[lo : lo + PACK_CHUNK]
        hi = lo + len(part)
        try:
            small = np.array(part, dtype=np.int64)
            if small.size and small.min() < 0:
                raise OverflowError
        except (OverflowError, TypeError):
            obj = np.array(part, dtype=object)
            fits = (obj >= 0) & (obj < 1 << 63)
            small = np.where(fits, obj, 0).astype(np.int64)
            big = np.flatnonzero(~fits)
            vals = [int(part[i]) % p if p is not None else int(part[i]) for i in big]
            buf = b"".join(x.to_bytes(32, "little") for x in vals)
            out[:, lo + big] = np.frombuffer(buf, dtype="<u4").reshape(len(big), NLIMBS).T
        u = small.view(np.uint64)
        out[0, lo:hi] |= (u & 0xFFFFFFFF).astype(np.uint32)
        out[1, lo:hi] |= (u >> 32).astype(np.uint32)
    out = out.view(np.int32)
    if shape is not None:
        out = out.reshape((NLIMBS, *shape))
    return out


def limbs_to_ints(arr) -> list[int]:
    """(8, ...) limbs (tensor or array) -> list of ints, batch order."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr).view(np.uint32).reshape(NLIMBS, -1)
    buf = np.ascontiguousarray(a.T).astype("<u4").tobytes()
    return [int.from_bytes(buf[32 * j : 32 * (j + 1)], "little") for j in range(a.shape[1])]


# ---------------------------------------------------------------------------
# Field context
# ---------------------------------------------------------------------------


class DeviceField:
    """Per-modulus constants of the device arithmetic.

    `kernel_params` are the 17 words the CUDA kernels take: p (8 limbs),
    -p^-1 mod 2^32, and R mod p (8 limbs). Instances are interned through
    device_field()."""

    def __init__(self, params: FieldParams):
        self.params = params
        p = params.p
        self.p = p
        self.pinv = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.r_mod_p = R % p
        self.r2_mod_p = R * R % p
        self.r_inv = pow(R, -1, p)
        self.kernel_params = np.array(
            int_to_words(p) + [self.pinv] + int_to_words(self.r_mod_p), dtype=np.uint32
        )
        self._cols: dict[tuple[int, str], torch.Tensor] = {}

    def const(self, x: int, batch_shape=(), *, device) -> torch.Tensor:
        """Canonical constant broadcast to (8, *batch_shape) (a read-only
        view). The column is copied to the device once per (value, device):
        a copy from host memory waits for the stream, so constants made
        inside a loop would otherwise stall the card at every use."""
        key = (x % self.p, str(torch.device(device)))
        col = self._cols.get(key)
        if col is None:
            col = self._cols[key] = torch.tensor(ints_to_limbs([key[0]]), device=device)
        return col.reshape((NLIMBS,) + (1,) * len(batch_shape)).expand(NLIMBS, *batch_shape)

    def const_mont(self, x: int, batch_shape=(), *, device) -> torch.Tensor:
        return self.const(x * self.r_mod_p % self.p, batch_shape, device=device)

    def zeros(self, batch_shape=(), *, device) -> torch.Tensor:
        return torch.zeros((NLIMBS, *batch_shape), dtype=torch.int32, device=device)

    def one_mont(self, batch_shape=(), *, device) -> torch.Tensor:
        return self.const(self.r_mod_p, batch_shape, device=device)

    def pack(self, xs: Sequence[int], shape=None, *, device) -> torch.Tensor:
        return torch.from_numpy(ints_to_limbs(xs, shape, self.p)).to(device)

    def pack_mont(self, xs: Sequence[int], shape=None, *, device) -> torch.Tensor:
        """Python ints (standard form) -> Montgomery form on `device`; the
        multiplication by R runs on the device (one K1 launch)."""
        return to_mont(self, self.pack(xs, shape, device=device))

    def unpack(self, arr) -> list[int]:
        return limbs_to_ints(arr)

    def unpack_mont(self, arr) -> list[int]:
        rinv, p = self.r_inv, self.p
        return [x * rinv % p for x in limbs_to_ints(arr)]


@functools.lru_cache(maxsize=None)
def device_field(params: FieldParams) -> DeviceField:
    return DeviceField(params)


# ---------------------------------------------------------------------------
# Torch ops (no kernel): canonical in, canonical out
# ---------------------------------------------------------------------------


def add(F: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p. Representation-agnostic."""
    P = kernels.field16(F, a.device)
    return from16(kernels.add16(P, to16(a), to16(b)))


def sub(F: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    P = kernels.field16(F, a.device)
    return from16(kernels.sub16(P, to16(a), to16(b)))


def neg(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    return sub(F, torch.zeros_like(a), a)


def is_zero(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Boolean mask (batch shape) of elements equal to zero."""
    return (a == 0).all(dim=0)


def eq(F: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(cond: torch.Tensor, t: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Elementwise select over limb tensors; cond has the batch shape."""
    return torch.where(cond[None], t, f)


# ---------------------------------------------------------------------------
# Kernel-backed ops
# ---------------------------------------------------------------------------


def mont_mul(F: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p (K1), with broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return kernels.mont_mul(F, a.contiguous(), b.contiguous())


def mont_sqr(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(F, a, a)


def to_mont(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Standard form -> Montgomery form (multiply by R^2)."""
    return mont_mul(F, a, F.const(F.r2_mod_p, a.shape[1:], device=a.device))


def from_mont(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> standard form (the product with plain 1 is REDC)."""
    return mont_mul(F, a, F.const(1, a.shape[1:], device=a.device))


def mont_pow(F: DeviceField, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent (K4); a in Montgomery form."""
    return kernels.mont_pow(F, a.contiguous(), e)


def inv(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2), 0 -> 0."""
    r = mont_pow(F, a, F.p - 2)
    return select(is_zero(F, a), torch.zeros_like(a), r)


# Longest row, in chunks of 128, that K5 scans in one block; longer rows
# stream through K12 and one K1 combine (pallas_field.py:1030-1034).
FUSED_SCAN_CHUNKS = 64


def prefix_mul(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the last axis: K5 for rows of at
    most 64 chunks of 128, else K12's parts and one K1 product of each
    position with its lane's offset, sliced to n."""
    a = a.contiguous()
    n = a.shape[-1]
    if kernels.scan_chunk(n) <= FUSED_SCAN_CHUNKS:
        return kernels.mont_prefix_scan(F, a)
    partial, excl, cp = kernels.mont_prefix_scan_parts(F, a)
    return mont_mul(F, partial, excl.repeat_interleave(cp, dim=-1))[..., :n]


def batch_inverse(F: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Montgomery-trick batch inversion of all elements; zeros -> zero.

    Prefix and suffix products (prefix_mul twice), one Fermat inversion of
    the total (K4) and a combine, as in the JAX package."""
    shape = a.shape
    a2 = a.reshape(NLIMBS, -1)
    zmask = is_zero(F, a2)
    ones = F.one_mont((1,), device=a.device)
    a1 = select(zmask, ones.expand_as(a2), a2)
    pref = prefix_mul(F, a1)
    total_inv = inv(F, pref[:, -1:])
    suf = prefix_mul(F, a1.flip(-1)).flip(-1)
    p_prev = torch.cat([ones, pref[:, :-1]], dim=-1)
    s_next = torch.cat([suf[:, 1:], ones], dim=-1)
    out = mont_mul(F, mont_mul(F, p_prev, s_next), total_inv)
    out = select(zmask, torch.zeros_like(out), out)
    return out.reshape(shape)
