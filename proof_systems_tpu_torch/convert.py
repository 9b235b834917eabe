"""Carry state of the JAX package across to the port, as numpy data and
plain integers.

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


def _point(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def column_proof_fields(proof) -> dict:
    """Either package's o1vm ColumnProof, field by field, as plain ints and
    (x, y) point tuples (None for infinity)."""
    op = proof.opening
    return dict(
        commitments=[[_point(p) for p in c.chunks] for c in proof.commitments],
        zeta_evaluations=[int(x) for x in proof.zeta_evaluations],
        zeta_omega_evaluations=[int(x) for x in proof.zeta_omega_evaluations],
        quotient_commitment=[_point(p) for p in proof.quotient_commitment.chunks],
        quotient_evaluations=tuple([int(x) for x in ev] for ev in proof.quotient_evaluations),
        opening=dict(lr=[(_point(a), _point(b)) for a, b in op.lr], delta=_point(op.delta),
                     z1=int(op.z1), z2=int(op.z2), sg=_point(op.sg)),
    )


def column_proof_from_fields(fields: dict, classes=None):
    """A ColumnProof from column_proof_fields: the port's, or another
    package's when `classes` is its (ColumnProof, PolyComm, OpeningProof)."""
    if classes is None:
        from .o1vm.pickles import ColumnProof
        from .poly_commitment.commitment import PolyComm
        from .poly_commitment.ipa import OpeningProof

        classes = (ColumnProof, PolyComm, OpeningProof)
    proof_cls, comm_cls, opening_cls = classes
    op = fields["opening"]
    return proof_cls(
        commitments=[comm_cls(list(c)) for c in fields["commitments"]],
        zeta_evaluations=list(fields["zeta_evaluations"]),
        zeta_omega_evaluations=list(fields["zeta_omega_evaluations"]),
        quotient_commitment=comm_cls(list(fields["quotient_commitment"])),
        quotient_evaluations=tuple(list(ev) for ev in fields["quotient_evaluations"]),
        opening=opening_cls(lr=list(op["lr"]), delta=op["delta"], z1=op["z1"], z2=op["z2"],
                            sg=op["sg"]),
    )
