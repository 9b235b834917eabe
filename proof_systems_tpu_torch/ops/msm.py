"""Multi-scalar multiplication (Pippenger) on device.

Counterpart of proof_systems_tpu/ops/msm.py (`_window_sums_body`,
`sum_windows`, `_combine_windows_body`, `_msm_affine`, `_msm_affine_scaled`,
`msm`). All W windows and all b MSMs of a batch are folded into leading
axes (W, b):

  - digits: c-bit windows of the canonical scalars;
  - bucket accumulation: sort each (window, MSM) row by digit with a packed
    int64 key, gather the affine-encoded points in that order (x, y and the
    infinity flag; z is rebuilt from the flag), and run the blocked prefix
    scan K6 (mixed additions); the bucket sums are differences of prefix
    values at the bucket boundaries, found by searchsorted and rebuilt as
    excl[j // cp] + partial[j] (K2);
  - weighted bucket reduction sum_d d*B_d: a suffix scan (K7) and a sum
    (K6 + one K2 add);
  - windows, two ways:
      scaled: the bases are pre-scaled by 2^(cw) (scale_basis, K3), so the
        W window sums combine by a log2(W) pairwise tree of K2 adds;
      unscaled: one set of bases for every window, and the window sums
        combine by the Horner chain of K8 (combine_windows). Bases that
        change per call (the verifier, the IPA rounds) take this path;
    then one affine normalisation (K1, K4, K5).

The point sources of the bucket gather are a scaled basis (8, W, n), affine
bases shared by the batch (8, n) or one set per MSM (8, b, n), or a table
with pre-composed row indices (table (8, R), row_idx (W, b, n)). The sort,
gathers and searchsorted are torch ops, as they were XLA ops in the JAX
package.

Under a data mesh (parallel/auto.py) `msm` shards each pass over the ranks
as the JAX package's msm() does (ops/msm.py:622-640): by batch rows when
the pass's rows split evenly (`_batch_sharded_msm`, an all_gather of the
affine results), else by points (`_point_sharded_msm`: identity-padded to
a multiple of the world size, an all_gather of the (W, b) window partials,
folded with K2 adds).
"""

from __future__ import annotations

import torch

from ..curves import CurveParams
from ..parallel.auto import Mesh, all_gather, mesh_for
from ..runtime import check_device, resolve_device
from . import kernels, limb
from .curve_ops import APoint, DeviceCurve, JPoint, device_curve, map_points, stack_points

# Batch split: a (window, MSM, point) element is one Jacobian point, 96 B in
# 8x32-bit limbs. At k = 16 (n = 2^16 + 1, c = 11, W = 24) and b = 16 that
# is 25.2M elements, 2.4 GB per live buffer; the gathered points, the scan
# partials and the sort keys keep about three such buffers alive. 2^25
# elements (3.2 GB a buffer, about 10 GB in all) commits the prover's
# 15 witness columns in one pass and stays far inside 80 GB.
MAX_WINDOW_ELEMS = 1 << 25


def num_windows(c: int) -> int:
    return -(-255 // c)


def window_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(8, b, n) canonical scalar limbs -> (W, b, n) int64 c-bit digits."""
    s = scalars.to(torch.int64) & 0xFFFFFFFF
    mask = (1 << c) - 1
    out = []
    for w in range(num_windows(c)):
        li, sh = divmod(c * w, limb.LIMB_BITS)
        v = s[li] >> sh
        if sh + c > limb.LIMB_BITS and li + 1 < limb.NLIMBS:
            v = v | (s[li + 1] << (limb.LIMB_BITS - sh))
        out.append(v & mask)
    return torch.stack(out)


def sort_digits(digits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of each row by digit through one packed int64 key
    (digit << idx_bits | position); returns (order, sorted digits)."""
    n = digits.shape[-1]
    idx_bits = max(n - 1, 1).bit_length()
    pos = torch.arange(n, dtype=torch.int64, device=digits.device)
    key, _ = torch.sort((digits << idx_bits) | pos, dim=-1)
    return key & ((1 << idx_bits) - 1), key >> idx_bits


def gather_points(curve: DeviceCurve, source, order: torch.Tensor) -> JPoint:
    """Affine-encoded points of each (window, MSM) row in sorted order,
    (8, W, b, n): one flat table of points (x, y, infinity flag) and global
    row indices into it; z is rebuilt from the flag (0 or one)."""
    W, b, n = order.shape
    if isinstance(source, JPoint):  # scaled basis (8, W, n), z in {0, R}
        table = APoint(source.x.reshape(limb.NLIMBS, W * n), source.y.reshape(limb.NLIMBS, W * n),
                       limb.is_zero(curve.F, source.z).reshape(W * n))
        rows = order + (torch.arange(W, device=order.device) * n)[:, None, None]
    elif isinstance(source, APoint):
        if source.x.dim() == 2:  # (8, n) shared by every window and MSM
            table, rows = source, order
        else:  # (8, b, n): one point set per MSM
            table = APoint(source.x.reshape(limb.NLIMBS, b * n), source.y.reshape(limb.NLIMBS, b * n),
                           source.inf.reshape(b * n))
            rows = order + (torch.arange(b, device=order.device) * n)[None, :, None]
    else:  # (table (8, R), row_idx (W, b, n)): indices composed by the caller
        table, row_idx = source
        rows = torch.gather(row_idx, -1, order)
    one = curve.F.one_mont((W, b, n), device=order.device)
    z = limb.select(table.inf[rows], one.new_zeros(()), one)
    return JPoint(table.x[:, rows], table.y[:, rows], z)


def _ec_prefix(curve: DeviceCurve, pts: JPoint) -> JPoint:
    """Inclusive prefix scan along the last axis (K7)."""
    return JPoint(*kernels.ec_prefix_scan_fused(curve.F, *map_points(torch.Tensor.contiguous, pts)))


def _scan_sum(curve: DeviceCurve, pts: JPoint) -> JPoint:
    """Sum along the last axis, shape (..., 1): phases 1-2 only (K6), then
    the last chunk's partial plus its exclusive offset (K2)."""
    partial, excl, _cp = kernels.ec_prefix_scan_parts(
        curve.F, *map_points(torch.Tensor.contiguous, pts)
    )
    last = JPoint(*(t[..., -1:] for t in partial))
    off = JPoint(*(t[..., -1:] for t in excl))
    return curve.add(off, last)


def scale_basis(curve: DeviceCurve, points: APoint, c: int, windows: int) -> JPoint:
    """Per-window scaled bases 2^(cw)*P_i, (8, W, n), affine-encoded
    (z in {0, R}) through one normalisation: the doubling chain (K3) runs
    once per SRS and the window recombination becomes a pairwise tree."""
    level = curve.to_jacobian(points)
    levels = [level]
    for _ in range(1, windows):
        for _ in range(c):
            level = curve.double(level)
        levels.append(level)
    return curve.to_jacobian(curve.to_affine(stack_points(levels, dim=1)))


def sum_windows(curve: DeviceCurve, wins: JPoint) -> JPoint:
    """sum_w wins[:, w] over axis 1 (pre-scaled bases): log2(W) adds."""
    W = wins.x.shape[1]
    Wp = 1
    while Wp < W:
        Wp *= 2
    if Wp != W:
        pad = curve.inf_jacobian((Wp - W, *wins.x.shape[2:]), device=wins.x.device)
        wins = JPoint(*(torch.cat([a, b], dim=1) for a, b in zip(wins, pad)))
    while Wp > 1:
        Wp //= 2
        wins = curve.add(
            JPoint(*(t[:, :Wp] for t in wins)), JPoint(*(t[:, Wp:] for t in wins))
        )
    return JPoint(*(t[:, 0] for t in wins))


def window_sums(curve: DeviceCurve, scalars: torch.Tensor, source, c: int) -> JPoint:
    """All per-window Pippenger partial sums, batch shape (W, b).

    scalars: (8, b, n) canonical (standard-form) limbs. source: the points,
    in one of the forms of gather_points. A scaled basis MUST be
    affine-encoded (z in {0, R}): only its infinity flag is gathered."""
    W, D = num_windows(c), 1 << c
    b, n = scalars.shape[1], scalars.shape[2]
    dev = scalars.device
    order, sdig = sort_digits(window_digits(scalars, c))
    jac = gather_points(curve, source, order)

    # bucket boundaries: ends[d] = #elements with digit <= d
    partial, excl, cp = kernels.ec_prefix_scan_parts(curve.F, *jac, mixed=True)
    buckets = torch.arange(D, dtype=torch.int64, device=dev).expand(W * b, D).contiguous()
    ends = torch.searchsorted(sdig.reshape(W * b, n), buckets, right=True).reshape(W, b, D)
    idx_lo = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]], dim=-1)
    t_all = torch.cat([ends, idx_lo], dim=-1)  # (W, b, 2D)
    j_all = t_all.clamp(min=1) - 1
    at_j = j_all.expand(limb.NLIMBS, W, b, 2 * D)
    at_lane = (j_all // cp).expand(limb.NLIMBS, W, b, 2 * D)
    # prefix value of the first t points = excl[lane of t-1] + partial[t-1]
    cum = curve.add(
        JPoint(*(torch.gather(t, -1, at_lane) for t in excl)),
        JPoint(*(torch.gather(t, -1, at_j) for t in partial)),
    )
    cum = JPoint(cum.x, cum.y, limb.select(t_all == 0, torch.zeros_like(cum.z), cum.z))
    hi = JPoint(*(t[..., :D] for t in cum))
    lo = JPoint(*(t[..., D:] for t in cum))
    sums = curve.add(hi, curve.neg(lo))  # bucket d sums, (W, b, D)

    # drop bucket 0; sum_d d*B_d = sum of the suffix scan over d = D-1..1
    rev = JPoint(*(t[..., 1:].flip(-1) for t in sums))
    win = _scan_sum(curve, _ec_prefix(curve, rev))
    return JPoint(*(t[..., 0] for t in win))


def combine_windows(curve: DeviceCurve, c: int, wins: JPoint) -> JPoint:
    """sum_w 2^(cw) * wins[:, w] over axis 1 (unscaled bases): K8's Horner
    chain, one thread per MSM."""
    return JPoint(*kernels.combine_windows(curve.F, c, *map_points(torch.Tensor.contiguous, wins)))


def msm_affine_scaled(curve: DeviceCurve, scalars: torch.Tensor, spoints: JPoint, c: int) -> APoint:
    """b MSMs over the scaled basis; affine results, batch shape (b,)."""
    return curve.to_affine(sum_windows(curve, window_sums(curve, scalars, spoints, c)))


def msm_affine(curve: DeviceCurve, scalars: torch.Tensor, points, c: int) -> APoint:
    """b MSMs over unscaled bases (any source of gather_points); affine
    results, batch shape (b,)."""
    return curve.to_affine(combine_windows(curve, c, window_sums(curve, scalars, points, c)))


def _affine_from_gathered(g: torch.Tensor) -> APoint:
    """(ranks, 17, b_local) gathered packs -> APoint of ranks * b_local."""
    g = g.permute(1, 0, 2).reshape(2 * limb.NLIMBS + 1, -1)
    return APoint(g[: limb.NLIMBS].contiguous(), g[limb.NLIMBS : 2 * limb.NLIMBS].contiguous(),
                  g[2 * limb.NLIMBS].bool())


def _batch_sharded_msm(curve: DeviceCurve, scalars: torch.Tensor, source, c: int,
                       use_scaled: bool, mesh: Mesh) -> APoint:
    """Batch-sharded MSMs (the JAX package's _sharded_msm_fn): each rank runs
    the whole Pippenger pipeline on its b / size rows over the replicated
    bases, then one all_gather of the affine results (x, y and the
    infinity flag as int32)."""
    rows = scalars.shape[1] // mesh.size
    part = scalars[:, mesh.rank * rows : (mesh.rank + 1) * rows].contiguous()
    aff = (msm_affine_scaled if use_scaled else msm_affine)(curve, part, source, c)
    packed = torch.cat([aff.x, aff.y, aff.inf.to(torch.int32)[None]], dim=0)
    return _affine_from_gathered(all_gather(packed, mesh))


def _pad_points_for_shard(scalars: torch.Tensor, source, use_scaled: bool, npad: int):
    """Pad the point axis to npad with identity points and zero scalars:
    z = 0 in a scaled basis, the infinity flag in affine bases."""
    extra = npad - scalars.shape[2]
    scalars = torch.nn.functional.pad(scalars, (0, extra))
    if use_scaled:
        return scalars, JPoint(*(torch.nn.functional.pad(t, (0, extra)) for t in source))
    return scalars, APoint(torch.nn.functional.pad(source.x, (0, extra)),
                           torch.nn.functional.pad(source.y, (0, extra)),
                           torch.nn.functional.pad(source.inf, (0, extra), value=True))


def _point_sharded_msm(curve: DeviceCurve, scalars: torch.Tensor, source, c: int,
                       use_scaled: bool, mesh: Mesh) -> APoint:
    """Point-sharded MSMs (the JAX package's _point_sharded_msm_fn), for
    batches that do not split over the ranks: each rank computes the window
    sums of its n / size points (n a multiple of the world size, see
    _pad_points_for_shard), one all_gather collects the (W, b) Jacobian
    partials, size - 1 K2 adds fold them, then the windows combine (the
    pairwise tree for a scaled basis, K8 otherwise) and one affine
    normalisation."""
    n = scalars.shape[2]
    if n % mesh.size:
        raise ValueError(f"{n} points do not split over {mesh.size} ranks; pad them")
    span = slice(mesh.rank * (n // mesh.size), (mesh.rank + 1) * (n // mesh.size))
    part = scalars[..., span].contiguous()
    if use_scaled:
        local = JPoint(*(t[..., span].contiguous() for t in source))
    else:
        local = APoint(source.x[:, span].contiguous(), source.y[:, span].contiguous(),
                       source.inf[span].contiguous())
    wins = window_sums(curve, part, local, c)  # (8, W, b)
    gathered = all_gather(torch.stack(list(wins)), mesh)  # (size, 3, 8, W, b)
    total = JPoint(*gathered[0])
    for i in range(1, mesh.size):
        total = curve.add(total, JPoint(*gathered[i]))
    comb = sum_windows(curve, total) if use_scaled else combine_windows(curve, c, total)
    return curve.to_affine(comb)


def msm_affine_routed(curve: DeviceCurve, scalars: torch.Tensor, source, c: int,
                      use_scaled: bool) -> APoint:
    """One pass of b MSMs over a scaled basis (use_scaled) or affine bases
    (8, n), on the data mesh's route when a mesh is up (the choice of the
    JAX package's msm(), ops/msm.py:622-640): batch-sharded when the rows
    split over the ranks, else point-sharded with identity padding. The
    affine results, batch shape (b,), are the same on every rank."""
    mesh = mesh_for(scalars)
    if mesh is None:
        return (msm_affine_scaled if use_scaled else msm_affine)(curve, scalars, source, c)
    if scalars.shape[1] % mesh.size == 0:
        return _batch_sharded_msm(curve, scalars, source, c, use_scaled, mesh)
    n = scalars.shape[2]
    npad = -(-n // mesh.size) * mesh.size
    if npad != n:
        scalars, source = _pad_points_for_shard(scalars, source, use_scaled, npad)
    return _point_sharded_msm(curve, scalars, source, c, use_scaled, mesh)


def default_window_bits(n: int) -> int:
    """Window size c of the JAX package's cost model (ops/msm.py:534): per
    window, the main scan's chunk steps and Hillis-Steele levels, the
    boundary adds over 2^c buckets and the bucket reduction's two scans,
    with chunks of ceil(n / 128) positions. The port's scans have the same
    geometry (128 threads a row), so the model carries over."""
    best, best_cost = 6, None
    C = -(-n // kernels.LANES)
    for c in range(6, 14):
        W = num_windows(c)
        Cb = -(-(1 << c) // kernels.LANES)
        cost = W * ((C - 1 + 7) + 3 * Cb + (2 * Cb + 6) + (Cb + 7))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def msm(
    curve_params: CurveParams,
    scalars_std: torch.Tensor,
    points: APoint | None = None,
    c: int | None = None,
    scaled: JPoint | None = None,
    device=None,
) -> list:
    """Batched MSM: b host affine points (None for infinity).

    scalars_std: (8, b, n) canonical standard-form limbs (not Montgomery),
    on `device` (the CUDA card unless device="cpu"). points: the n affine
    bases (8, n), shared by the batch; scaled: their pre-scaled windows at
    window size c. With `scaled` the MSM takes the scaled path; with only
    `points` the unscaled path (window sums, then K8), as the JAX package
    does for bases that change per call. Under a data mesh each pass takes
    the mesh's route (msm_affine_routed)."""
    check_device(scalars_std, resolve_device(device), "scalars")
    curve = device_curve(curve_params)
    b, n = scalars_std.shape[1], scalars_std.shape[2]
    if c is None:
        c = default_window_bits(n)
    windows = num_windows(c)
    if scaled is not None:
        if tuple(scaled.x.shape[1:]) != (windows, n):
            raise ValueError(f"scaled basis {tuple(scaled.x.shape)} does not match c={c}, n={n}")

        source = scaled
    elif points is not None:
        if tuple(points.x.shape) != (limb.NLIMBS, n):
            raise ValueError(f"points {tuple(points.x.shape)} do not match n={n}")
        source = points
    else:
        raise ValueError("msm needs the points or their scaled basis")
    # a row of a pass holds W·n gathered points and, in the bucket
    # reduction, W·2^(c+1) bucket boundaries: the latter rule short rows
    split = b
    while split > 1 and windows * split * max(n, 2 << c) > MAX_WINDOW_ELEMS:
        split = -(-split // 2)
    out = []
    for lo in range(0, b, split):
        part = scalars_std[:, lo : lo + split]
        out.extend(curve.unpack_affine(
            msm_affine_routed(curve, part, source, c, use_scaled=scaled is not None)))
    return out
