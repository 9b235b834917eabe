"""Multi-device steps of the proving pipeline over the data mesh.

Counterpart of proof_systems_tpu/parallel/mesh.py:
  - column parallelism: the columns of an NTT -> pointwise -> iNTT step
    shard over the ranks with no communication, and a cross-column
    modular sum combines the ranks' partials (sharded_ntt_step);
  - a point-sharded Pippenger MSM: each rank's window sums over its
    points, one all_gather of the (W, b) partials and a fold of K2 adds
    (sharded_msm), checked against the host MSM by sharded_msm_check.
Each function runs on every rank of the mesh and returns the same values
on every rank.
"""

from __future__ import annotations

import random

import torch

from ..curves import Vesta
from ..fields import Fp
from ..ops import limb, ntt
from ..ops import msm as msm_mod
from ..ops.curve_ops import device_curve
from .auto import Mesh, all_gather


def sharded_ntt_step(mesh: Mesh, n_devices: int, log_n: int = 6, cols_per_dev: int = 2):
    """One column-sharded NTT / square / iNTT step, checked.

    b = n_devices * cols_per_dev columns of the JAX package's values
    ((i % 97) + 1); each rank transforms its cols_per_dev columns, sums
    them by a halving tree of field adds, and the ranks' partials are
    all-gathered and summed in rank order. The check: that total equals
    the host's modular sum of every column gathered. Returns (the columns
    after the step (8, b, n), the total (8, n)), identical on every rank."""
    if n_devices != mesh.size:
        raise ValueError(f"{n_devices} devices asked, the mesh has {mesh.size}")
    plan = ntt.ntt_plan(Fp, log_n, device=mesh.device)
    F = limb.device_field(Fp)
    n = plan.n
    b = n_devices * cols_per_dev
    lo = mesh.rank * cols_per_dev
    vals = F.pack_mont([(i % 97) + 1 for i in range(lo * n, (lo + cols_per_dev) * n)],
                       shape=(cols_per_dev, n), device=mesh.device)

    evals = plan.ntt(vals)
    back = plan.intt(limb.mont_mul(F, evals, evals))
    local = back
    k = cols_per_dev
    while k > 1:
        k //= 2
        local = limb.add(F, local[:, :k], local[:, k:])
    partials = all_gather(local[:, 0], mesh)  # (size, 8, n)
    total = partials[0]
    for r in range(1, mesh.size):
        total = limb.add(F, total, partials[r])
    cols = all_gather(back, mesh).permute(1, 0, 2, 3).reshape(limb.NLIMBS, b, n)

    got = F.unpack_mont(total)
    col_vals = F.unpack_mont(cols)
    want = [sum(col_vals[c * n + j] for c in range(b)) % Fp.p for j in range(n)]
    if got != want:
        raise AssertionError("sharded NTT step mismatch")
    return cols, total


def sharded_msm(mesh: Mesh, curve_params, scalars: torch.Tensor, points, c: int = 8):
    """Point-sharded Pippenger MSM: scalars (8, b, n) canonical, points an
    affine (8, n) APoint, both replicated, n a multiple of the world size.
    Each rank's window sums over its n / size points, one all_gather of the
    (W, b) Jacobian partials, size - 1 K2 adds per window, K8's window
    recombination, one affine normalisation. Returns the (b,) affine
    APoint, the same on every rank."""
    return msm_mod._point_sharded_msm(device_curve(curve_params), scalars, points, c,
                                      use_scaled=False, mesh=mesh)


def sharded_msm_check(mesh: Mesh, n_devices: int, n: int = 32, b: int = 2):
    """sharded_msm on the JAX package's toy data (random.Random(5)) against
    the host MSM; returns the host points."""
    if n_devices != mesh.size:
        raise ValueError(f"{n_devices} devices asked, the mesh has {mesh.size}")
    rng = random.Random(5)
    curve = device_curve(Vesta)
    g = Vesta.generator
    pts = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(n)]
    scal_rows = [[rng.randrange(Vesta.scalar.p) for _ in range(n)] for _ in range(b)]
    scal = torch.from_numpy(limb.ints_to_limbs([s for row in scal_rows for s in row],
                                               shape=(b, n))).to(mesh.device)
    aff = sharded_msm(mesh, Vesta, scal, curve.pack_affine(pts, device=mesh.device), c=8)
    got = curve.unpack_affine(aff)
    want = [Vesta.msm(row, pts) for row in scal_rows]
    if got != want:
        raise AssertionError("sharded MSM mismatch")
    return got
