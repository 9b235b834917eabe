"""Carry state of the JAX package across to the port, as numpy data.

The JAX package holds a field element as (16, ...) uint32 with 16-bit
limbs; the port as (8, ...) int32 with 32-bit limbs. Both hold the same
Montgomery integer, so the conversion is a regrouping of limbs. Nothing
here imports JAX: callers pass numpy arrays (`np.asarray(jax_array)`).
"""

from __future__ import annotations

import numpy as np
import torch

from .curves import CurveParams, Vesta
from .poly_commitment.srs import SRS
from .runtime import resolve_device


def limbs_from_numpy(arr, device=None) -> torch.Tensor:
    """(16, ...) uint32 16-bit limbs -> the port's (8, ...) int32 tensor on
    `device` (the card unless the caller asks for the CPU)."""
    a = np.asarray(arr, dtype=np.uint32)
    if a.shape[0] != 16 or (a > 0xFFFF).any():
        raise ValueError("expected (16, ...) canonical 16-bit limbs")
    words = a[0::2] | (a[1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(resolve_device(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's (8, ...) int32 tensor -> (16, ...) uint32 16-bit limbs."""
    w = t.detach().cpu().numpy().view(np.uint32)
    out = np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], axis=1)
    return out.reshape(16, *w.shape[1:])


def srs_from_numpy(g, h, curve: CurveParams = Vesta, device=None) -> SRS:
    """The port's SRS from the JAX SRS's points: `g` in the (n, 2) object
    array format of its npy cache, `h` an (x, y) pair."""
    pts = [(int(x), int(y)) for x, y in np.asarray(g, dtype=object)]
    hx, hy = h
    return SRS(curve, pts, (int(hx), int(hy)), resolve_device(device))
