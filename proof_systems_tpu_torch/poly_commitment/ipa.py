"""IPA polynomial commitment opening proofs: open and batch verify.

Counterpart of proof_systems_tpu/poly_commitment/ipa.py, with the
semantics of poly-commitment/src/ipa.rs:
  - open (ipa.rs:687-927): combine the polynomials with powers of
    polyscale, absorb shift_scalar(<a, b>), derive U from a base-field
    challenge through the group map, run log2(n) folding rounds (L/R
    Pedersen MSMs, 128-bit endo-expanded challenges), finish with the
    Schnorr-style (delta, z1, z2) and the folded base sg;
  - verify (ipa.rs:195-385): one randomly weighted MSM over
    [h] ++ g ++ per-proof {sg, U, L/R, evaluation commitments, delta}
    that must be the identity, with s = b_poly_coefficients(challenges)
    as the scalars of g;
  - the challenges re-derived from the transcript (ipa.rs:1099-1140).

The round loop runs on the device, the design of the reference's
`_open_rounds_device`: while the basis is large each round folds it
explicitly (`_ipa_fold_step`, g' = g_lo + [u] g_hi by the endo ladder),
then the last rounds run over a fixed masked basis of IPA_FOLD_TAIL points
(`_ipa_tail_rounds`). Between rounds the sponge state, the challenge bits
and u, u^-1 stay on the device (K10 sponge_squeeze2, bits128, K11
endo_inv); the packed L/R points of every round, sg, a0 and b0 come back in
one fetch after the loop, and the host replays the transcript to recover
the challenges. The reference's per-round host loop (`_open_rounds_host`)
is its CPU golden model; here the plain versions of the kernels take that
role, so one loop serves the card and the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..curves import AffinePoint, CurveParams
from ..ops import kernels, limb, msm, ntt, poly
from ..ops.curve_ops import APoint, DeviceCurve, device_curve
from ..poseidon.sponge import FqSponge
from ..runtime import resolve_device
from .commitment import PolyComm, b_poly, shift_scalar

# Basis size from which the rounds stop folding and run masked (the
# reference's PST_IPA_FOLD_TAIL default): k = 16 folds 5 times, then runs
# 11 rounds at 2048 points.
IPA_FOLD_TAIL = 2048


@dataclass
class OpeningProof:
    """ipa.rs:1042 — {lr, delta, z1, z2, sg}."""

    lr: list[tuple[AffinePoint, AffinePoint]]
    delta: AffinePoint
    z1: int
    z2: int
    sg: AffinePoint

    def challenges(self, curve: CurveParams, sponge: FqSponge):
        """Re-derive the round challenges from the transcript (ipa.rs:1124)."""
        f = curve.scalar
        _, endo_r = curve.endos
        chal = []
        for l, r in self.lr:
            sponge.absorb_g([l])
            sponge.absorb_g([r])
            chal.append(sponge.challenge().to_field(endo_r, f))
        return chal, [pow(c, -1, f.p) for c in chal]


@dataclass
class Evaluation:
    """A commitment plus its evaluations[point][chunk] (commitment.rs)."""

    commitment: PolyComm
    evaluations: list[list[int]]


@dataclass
class BatchEvaluationProof:
    sponge: FqSponge
    evaluations: list[Evaluation]
    evaluation_points: list[int]
    polyscale: int
    evalscale: int
    opening: OpeningProof
    combined_inner_product: int


def combine_polys_dev(F: limb.DeviceField, plnms, polyscale: int, srs_len: int, *, device):
    """sum_i polyscale^i * segment_i on the device (utils.rs:103
    combine_polys): every srs_len-chunk of every polynomial is one segment.

    plnms: list of (coeffs (8, L) Montgomery, blinder per chunk). Returns
    (combined (8, srs_len) Montgomery, combined blinder int)."""
    p = F.p
    blind, scale_i, idx = 0, 1, 0
    segs, scale_idx = [], []
    for coeffs, blinders in plnms:
        L = coeffs.shape[-1]
        for ci in range(max(-(-L // srs_len), len(blinders))):
            seg = coeffs[:, ci * srs_len : (ci + 1) * srs_len]
            if seg.shape[-1]:
                segs.append(torch.nn.functional.pad(seg, (0, srs_len - seg.shape[-1])))
                scale_idx.append(idx)
            blind = (blind + blinders[ci] * scale_i) % p
            scale_i = scale_i * polyscale % p
            idx += 1
    # the polyscale powers are a device squaring chain, the segment sum a
    # halving tree over the (padded) segment axis
    pows = poly.powers_dev(F, polyscale, idx, device=device)[:, scale_idx]
    terms = limb.mont_mul(F, torch.stack(segs, dim=-1), pows[:, None, :])  # (8, srs_len, S)
    return ntt.sum_mod(F, poly._pad_pow2(terms))[..., 0], blind


def open_proof(
    srs,
    plnms,
    elm: list[int],
    polyscale: int,
    evalscale: int,
    sponge: FqSponge,
    rng,
    *,
    tail_target: int = IPA_FOLD_TAIL,
) -> OpeningProof:
    """IPA opening (ipa.rs:687) on the SRS's device. plnms as in
    combine_polys_dev; elm are the evaluation points (zeta, zeta*omega);
    sponge is the running Fq transcript. The rounds fold the basis while it
    has more than tail_target points."""
    curve: CurveParams = srs.curve
    f = curve.scalar
    F = limb.device_field(f)
    dev = srs.device
    _, endo_r = curve.endos
    n = len(srs.g)
    rounds = max((n - 1).bit_length(), 1)
    if 1 << rounds != n:
        raise ValueError(f"the IPA needs a power-of-two SRS, got {n} points")

    a, blinding_factor = combine_polys_dev(F, plnms, polyscale, n, device=dev)

    # b_init[j] = sum_i evalscale^i * elm_i^j
    b_arr, scale = None, 1
    for e in elm:
        term = limb.mont_mul(F, poly.powers_dev(F, e, n, device=dev),
                             F.pack_mont([scale], shape=(1,), device=dev))
        b_arr = term if b_arr is None else limb.add(F, b_arr, term)
        scale = scale * evalscale % f.p
    cip = F.unpack_mont(ntt.dot_mod(F, a, b_arr))[0]

    sponge.absorb_fr([shift_scalar(curve, cip)])
    u_base = curve.to_group(sponge.challenge_fq())

    lr, blinders, chals, chal_invs, a0, b0, g0 = _open_rounds_device(
        srs, sponge, F, a, b_arr, u_base, rng, rounds, tail_target
    )

    r_prime = blinding_factor
    for (rand_l, rand_r), u, u_inv in zip(blinders, chals, chal_invs):
        r_prime = (r_prime + rand_l * u_inv + rand_r * u) % f.p

    d = rng.field(f.p)
    r_delta = rng.field(f.p)
    delta = curve.add(
        curve.scalar_mul(d, curve.add(g0, curve.scalar_mul(b0, u_base))),
        curve.scalar_mul(r_delta, srs.h),
    )
    sponge.absorb_g([delta])
    c = sponge.challenge().to_field(endo_r, f)
    z1 = (a0 * c + d) % f.p
    z2 = (r_prime * c + r_delta) % f.p
    return OpeningProof(lr=lr, delta=delta, z1=z1, z2=z2, sg=g0)


# ---------------------------------------------------------------------------
# The device round loop
# ---------------------------------------------------------------------------


def _pack_affine(aff: APoint):
    """Affine results as one (17, b) int32 block [x limbs; y limbs; inf]
    with infinity as (0, 0), the form the sponge absorbs; also (x, y)."""
    zero = torch.zeros_like(aff.x)
    xs = limb.select(aff.inf, zero, aff.x)
    ys = limb.select(aff.inf, zero, aff.y)
    return torch.cat([xs, ys, aff.inf.to(torch.int32)[None]]), xs, ys


def _unpack_affine(dc: DeviceCurve, packed: torch.Tensor) -> list:
    return dc.unpack_affine(APoint(packed[:8], packed[8:16], packed[16] != 0))


def _squeeze_challenge(F, Fq, endo_r: int, nrounds: int, state, xs, ys, consts):
    """One round's transcript on the device: absorb L, permute, absorb R,
    permute, read 128 bits (K10), then u and u^-1 (K11). Returns (state',
    the challenge bits, u, u^-1)."""
    state, chal = kernels.sponge_squeeze2(Fq, nrounds, state, xs, ys, consts)
    bits = kernels.bits128(chal)
    u, u_inv = kernels.endo_inv(F, endo_r, bits)
    return state, bits, u, u_inv


def _ipa_fold_step(F, Fq, dc: DeviceCurve, c: int, endo_r: int, nrounds: int,
                   a, b, g: APoint, hu: APoint, state, rand_pair, consts):
    """One round that folds the basis of size m (ipa.rs:845):

        L = <a_hi, g_lo> + rand_l*H + <a_hi, b_lo>*U
        R = <a_lo, g_hi> + rand_r*H + <a_lo, b_hi>*U
        u = endo(challenge);  a' = a_lo + u^-1 a_hi;  b' = b_lo + u b_hi
        g' = g_lo + [u] g_hi

    L and R are one b = 2 unscaled MSM over m/2 + 2 points (K8 combines
    its windows). [u]P is the 64-step endo ladder over the challenge bits,
    acc = 2*acc + (+-phi(P) or +-P): ScalarChallenge.to_field's (a, b)
    recurrence lifted to points, one kernel launch (DeviceCurve.endo_ladder).

    Returns (a', b', g', state', L/R packed (17, 2))."""
    half = a.shape[-1] // 2
    a_lo, a_hi = a[:, :half], a[:, half:]
    b_lo, b_hi = b[:, :half], b[:, half:]
    ips = torch.stack([ntt.dot_mod(F, a_hi, b_lo), ntt.dot_mod(F, a_lo, b_hi)], dim=1)
    body = torch.stack([a_hi, a_lo], dim=1)
    scal = torch.cat([limb.from_mont(F, body), rand_pair, limb.from_mont(F, ips)], dim=-1)
    pts = APoint(*(
        torch.stack([torch.cat([t[..., :half], e], -1), torch.cat([t[..., half:], e], -1)], dim=-2)
        for t, e in zip(g, hu)
    ))
    total = msm.combine_windows(dc, c, msm.window_sums(dc, scal, pts, c))
    lr, xs, ys = _pack_affine(dc.to_affine(total))
    state, bits, u, u_inv = _squeeze_challenge(F, Fq, endo_r, nrounds, state, xs, ys, consts)
    a2 = limb.add(F, a_lo, limb.mont_mul(F, a_hi, u_inv))
    b2 = limb.add(F, b_lo, limb.mont_mul(F, b_hi, u))

    # g' = g_lo + [u] g_hi; the ladder reads the bits on the device
    lo, hi = (APoint(*(t[..., s] for t in g)) for s in (slice(0, half), slice(half, None)))
    acc = dc.endo_ladder(dc.to_jacobian(hi), bits)
    g2 = dc.to_affine(dc.add(acc, dc.to_jacobian(lo)))
    return a2, b2, g2, state, lr


def _ipa_tail_rounds(F, Fq, dc: DeviceCurve, rounds: int, c: int, endo_r: int, nrounds: int,
                     a, b, g: APoint, hu: APoint, rand_lr_all, state, consts):
    """The last `rounds` rounds over a fixed (unfolded) basis of M points
    (the whole loop when n <= IPA_FOLD_TAIL). Round k's L/R touch only the
    basis half with bit_k = 0 / 1, so each round's MSM gathers a compact
    half through row indices composed into one packed [g ++ h ++ U] table;
    a and b keep length M with the active prefix m = M >> (k + 1) addressed
    by index arithmetic; mask[j] = prod_{r<k} u_r^bit_r(j) is the running
    b_poly coefficient pattern, and sg = <mask_final, g>.

    Returns (L/R packs [(17, 2)] * rounds, sg packed (17, 1), a0, b0)."""
    dev = a.device
    n = a.shape[-1]
    half = n // 2
    W = msm.num_windows(c)
    i_arr = torch.arange(n, device=dev)
    j_arr = torch.arange(half, device=dev)
    zeros_n = F.zeros((n,), device=dev)
    mask = F.one_mont((n,), device=dev)
    table = APoint(*(torch.cat([t, e], -1) for t, e in zip(g, hu)))
    hu_rows = torch.arange(n, n + 2, device=dev)
    packs = []
    for k in range(rounds):
        shift = rounds - 1 - k
        m = n >> (k + 1)
        bit_k = ((i_arr >> shift) & 1).bool()
        idx_lo = i_arr & (m - 1)
        idx_hi = idx_lo | m
        a_hi_t, a_lo_t, b_hi_t = a[:, idx_hi], a[:, idx_lo], b[:, idx_hi]
        prefix = i_arr < m
        ip_l = ntt.sum_mod(F, limb.select(prefix, limb.mont_mul(F, a_hi_t, b), zeros_n))
        ip_r = ntt.sum_mod(F, limb.select(prefix, limb.mont_mul(F, a, b_hi_t), zeros_n))

        idx_L = ((j_arr >> shift) << (shift + 1)) | (j_arr & ((1 << shift) - 1))
        idx_R = idx_L | (1 << shift)
        w_l = limb.mont_mul(F, mask, a_hi_t)[:, idx_L]
        w_r = limb.mont_mul(F, mask, a_lo_t)[:, idx_R]
        body = limb.from_mont(F, torch.stack([w_l, w_r], dim=1))
        ips = limb.from_mont(F, torch.stack([ip_l, ip_r], dim=1))
        scal = torch.cat([body, rand_lr_all[:, k], ips], dim=-1)  # (8, 2, half + 2)
        rows = torch.stack([torch.cat([idx_L, hu_rows]), torch.cat([idx_R, hu_rows])])
        wins = msm.window_sums(dc, scal, (table, rows.expand(W, 2, half + 2)), c)
        pack, xs, ys = _pack_affine(dc.to_affine(msm.combine_windows(dc, c, wins)))
        packs.append(pack)

        state, _, u, u_inv = _squeeze_challenge(F, Fq, endo_r, nrounds, state, xs, ys, consts)
        a = limb.add(F, a, limb.mont_mul(F, a_hi_t, u_inv))
        b = limb.add(F, b, limb.mont_mul(F, b_hi_t, u))
        mask = limb.select(bit_k, limb.mont_mul(F, mask, u), mask)

    # under a data mesh the sg commitment takes msm()'s route, as the JAX
    # package's does (ipa.py:329)
    sg = msm.msm_affine_routed(dc, limb.from_mont(F, mask)[:, None, :], g, c, use_scaled=False)
    return packs, _pack_affine(sg)[0], a[:, :1], b[:, :1]


def _open_rounds_device(srs, sponge: FqSponge, F, a, b, u_base, rng, rounds: int, tail_target: int):
    """Run the device round loop, fetch its results once, and replay the
    transcript on the host (the native permutation) to recover the
    challenges. Returns (lr, blinders, chals, chal_invs, a0, b0, sg)."""
    curve: CurveParams = srs.curve
    f = curve.scalar
    dc = device_curve(curve)
    dev = srs.device
    params = sponge.sponge.params
    Fq = limb.device_field(params.field)
    _, endo_r = curve.endos
    n = len(srs.g)

    blinders = [(rng.field(f.p), rng.field(f.p)) for _ in range(rounds)]
    rand_all = F.pack([v for pair in blinders for v in pair], shape=(rounds, 2, 1), device=dev)
    state = Fq.pack_mont(list(sponge.sponge.state), shape=(3,), device=dev)
    consts = kernels.sponge_consts(params, dev)
    hu = dc.pack_affine([srs.h, u_base], device=dev)

    # fold while the basis is larger than tail_target, then the masked tail
    f_rounds = max(0, rounds - (max(tail_target, 2).bit_length() - 1))
    g, packs = srs.g_dev, []
    for k in range(f_rounds):
        c_k = msm.default_window_bits((n >> k) // 2 + 2)
        a, b, g, state, lr = _ipa_fold_step(
            F, Fq, dc, c_k, endo_r, params.rounds_full, a, b, g, hu, state, rand_all[:, k],
            consts,
        )
        packs.append(lr)
    c_t = msm.default_window_bits((n >> f_rounds) // 2 + 2)
    lr_tail, sg, a0, b0 = _ipa_tail_rounds(
        F, Fq, dc, rounds - f_rounds, c_t, endo_r, params.rounds_full, a, b, g, hu,
        rand_all[:, f_rounds:], state, consts,
    )
    packs.extend(lr_tail)

    # the one fetch of the loop's results
    nlr = 17 * 2 * rounds
    host = torch.cat([torch.cat(packs, dim=1).reshape(-1), sg.reshape(-1),
                      torch.cat([a0, b0], dim=1).reshape(-1)]).cpu()
    lr_pts = _unpack_affine(dc, host[:nlr].reshape(17, 2 * rounds))
    sg_pt = _unpack_affine(dc, host[nlr : nlr + 17].reshape(17, 1))[0]
    a0, b0 = F.unpack_mont(host[nlr + 17 :].reshape(8, 2))

    lr, chals, chal_invs = [], [], []
    for k in range(rounds):
        l_pt, r_pt = lr_pts[2 * k], lr_pts[2 * k + 1]
        lr.append((l_pt, r_pt))
        sponge.absorb_g([l_pt])
        sponge.absorb_g([r_pt])
        u = sponge.challenge().to_field(endo_r, f)
        chals.append(u)
        chal_invs.append(pow(u, -1, f.p))
    return lr, blinders, chals, chal_invs, a0, b0, sg_pt


# ---------------------------------------------------------------------------
# Batch verification
# ---------------------------------------------------------------------------


def _accum_sg_scalars(F, rounds: int, chal_mont, w_mont, acc):
    """acc + w * s on the device, s = b_poly_coefficients(chals):
    s_i = prod_{j: bit_j(i) = 1} chal[rounds - 1 - j], built by `rounds`
    masked products over the whole (8, n) vector (ipa.rs:296 s-vector).

    chal_mont: (8, rounds) Montgomery challenges; w_mont: (8, 1) Montgomery
    weight; acc: (8, n) Montgomery."""
    n = acc.shape[-1]
    i_arr = torch.arange(n, device=acc.device)
    mask = w_mont.expand(limb.NLIMBS, n)
    for j in range(rounds):
        bit = ((i_arr >> (rounds - 1 - j)) & 1).bool()
        mask = limb.select(bit, limb.mont_mul(F, mask, chal_mont[:, j : j + 1]), mask)
    return limb.add(F, acc, mask)


def verify_batch(srs, batch: list[BatchEvaluationProof], rng) -> bool:
    """Batched IPA verification (ipa.rs:195-385) on the SRS's device: one
    b = 1 unscaled MSM over [h] ++ g ++ the per-proof points must be the
    identity."""
    curve: CurveParams = srs.curve
    f = curve.scalar
    _, endo_r = curve.endos
    dev = resolve_device(srs.device)  # the card unless the SRS names a device
    n = len(srs.g)
    rounds = max((n - 1).bit_length(), 1)
    if 1 << rounds != n:
        raise ValueError(f"the IPA needs a power-of-two SRS, got {n} points")

    # the scalar of h stays a host int; the s-vectors of g accumulate on
    # the device
    F = limb.device_field(f)
    acc = F.zeros((n,), device=dev)
    suffix_points: list[AffinePoint] = []
    suffix_scalars: list[int] = []
    h_scalar = 0

    rand_base = rng.field(f.p)
    sg_rand_base = rng.field(f.p)
    rand_base_i = 1
    sg_rand_base_i = 1

    for bp in batch:
        sponge = bp.sponge
        sponge.absorb_fr([shift_scalar(curve, bp.combined_inner_product)])
        u_base = curve.to_group(sponge.challenge_fq())

        chal, chal_inv = bp.opening.challenges(curve, sponge)
        sponge.absorb_g([bp.opening.delta])
        c = sponge.challenge().to_field(endo_r, f)

        b0, scale = 0, 1
        for e in bp.evaluation_points:
            b0 = (b0 + scale * b_poly(f, chal, e)) % f.p
            scale = scale * bp.evalscale % f.p

        acc = _accum_sg_scalars(
            F, rounds, F.pack_mont(chal, shape=(rounds,), device=dev),
            F.pack_mont([sg_rand_base_i], shape=(1,), device=dev), acc,
        )

        neg_rand_base_i = (-rand_base_i) % f.p
        suffix_points.append(bp.opening.sg)
        suffix_scalars.append((neg_rand_base_i * bp.opening.z1 - sg_rand_base_i) % f.p)
        h_scalar = (h_scalar - rand_base_i * bp.opening.z2) % f.p
        suffix_points.append(u_base)
        suffix_scalars.append(neg_rand_base_i * bp.opening.z1 * b0 % f.p)

        rand_base_i_c_i = c * rand_base_i % f.p
        for (l, r), u_inv, u in zip(bp.opening.lr, chal_inv, chal):
            suffix_points.append(l)
            suffix_scalars.append(rand_base_i_c_i * u_inv % f.p)
            suffix_points.append(r)
            suffix_scalars.append(rand_base_i_c_i * u % f.p)

        # evaluation commitments: sum of polyscale^i chunks
        xi_i = 1
        for ev in bp.evaluations:
            for ch in ev.commitment.chunks:
                suffix_points.append(ch)
                suffix_scalars.append(rand_base_i_c_i * xi_i % f.p)
                xi_i = xi_i * bp.polyscale % f.p

        suffix_points.append(u_base)
        suffix_scalars.append(rand_base_i_c_i * bp.combined_inner_product % f.p)
        suffix_points.append(bp.opening.delta)
        suffix_scalars.append(rand_base_i)

        rand_base_i = rand_base_i * rand_base % f.p
        sg_rand_base_i = sg_rand_base_i * sg_rand_base % f.p

    # [h] ++ g is packed once per SRS; only the per-proof points each call
    base = srs.hg_dev
    suffix = device_curve(curve).pack_affine(suffix_points, device=dev)
    points = APoint(*(torch.cat([s, t], -1) for s, t in zip(base, suffix)))
    scalars = torch.cat([
        F.pack([h_scalar], shape=(1,), device=dev),
        limb.from_mont(F, acc),
        F.pack(suffix_scalars, shape=(len(suffix_scalars),), device=dev),
    ], dim=-1)[:, None, :]
    return msm.msm(curve, scalars, points, device=dev)[0] is None
