"""The o1vm "pickles-style" column prover (o1vm/src/pickles/prover.rs:55,
verifier.rs:65) on the card.

Counterpart of proof_systems_tpu/o1vm/pickles.py. A lean proof system for
fixed column traces (no permutation argument, no zk rows): commit every
witness column (fixed +H hiding), squeeze a RAW 128-bit alpha, combine ALL
constraints with powers alpha^0.., take the quotient by Z_H over d8, commit
its 7 chunks, evaluate everything at zeta / zeta*omega, and produce one IPA
opening. The verifier re-evaluates the combined constraint at zeta from the
claimed column evaluations and checks quotient(zeta)·(zeta^n − 1) equality
before the batched IPA check.

Columns are a flat ordered batch; constraint cells reference ("o1vm", i)
with CURR/NEXT rows. The MIPS/RISC-V interpreters lower their named column
layouts onto this order.

On the device: batched iNTTs and one batched MSM commit the trace (the
transforms a batch of columns at a time, TRANSFORM_BATCH_BYTES), the
constraint walk (circuits/expr.eval_dev) runs batched limb ops over d8, and
the boundary rows' (x^n - 1)/(x - w^i) are computed there too, as the
Kimchi prover computes its own. Constants.endo_coefficient here is endo_r
of the proof curve (NOT the other curve's endo_q as in kimchi —
prover.rs:228).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circuits import expr as expr_mod
from ..curves import CurveParams
from ..ops import limb, poly
from ..ops.limb import NLIMBS
from ..poly_commitment.commitment import PolyComm, combined_inner_product
from ..poly_commitment.ipa import (
    BatchEvaluationProof,
    Evaluation,
    OpeningProof,
    open_proof,
    verify_batch,
)
from ..prover import fr_sponge_for
from ..runtime import check_device, resolve_device
from ..verifier_index import sponge_for

DEGREE_QUOTIENT_POLYNOMIAL = 7
# Bytes of (8, C, m) int32 words that one transform of a column batch takes
# in: its stages' temporaries (16-bit limbs in int64, both halves) are a
# few times that, so a wide trace's d8 transform stays a few GiB at a time
# whatever its number of columns. The transform of a column does not depend
# on the other columns of its batch: the results are the same.
TRANSFORM_BATCH_BYTES = 1 << 30


def column_batches(ncols: int, length: int) -> list[tuple[int, int]]:
    """[lo, hi) column ranges of at most TRANSFORM_BATCH_BYTES of words."""
    per = max(1, TRANSFORM_BATCH_BYTES // (NLIMBS * 4 * length))
    return [(lo, min(ncols, lo + per)) for lo in range(0, ncols, per)]


def intt_columns(d1, evals: torch.Tensor) -> torch.Tensor:
    """d1.intt of (8, C, n) evaluations, a column batch at a time."""
    out = torch.empty_like(evals)
    for lo, hi in column_batches(evals.shape[1], evals.shape[2]):
        out[:, lo:hi] = d1.intt(evals[:, lo:hi])
    return out


def d8_columns(d8, coeffs: torch.Tensor) -> torch.Tensor:
    """(8, C, n) coefficients -> (8, C, 8n) evaluations over d8, a column
    batch at a time."""
    n = coeffs.shape[2]
    out = torch.empty((NLIMBS, coeffs.shape[1], d8.n), dtype=coeffs.dtype, device=coeffs.device)
    for lo, hi in column_batches(coeffs.shape[1], d8.n):
        out[:, lo:hi] = d8.ntt(torch.nn.functional.pad(coeffs[:, lo:hi], (0, d8.n - n)))
    return out


def col(i: int):
    return ("o1vm", i)


def _collect_lagrange_offsets(constraints) -> set[int]:
    """Row offsets of every UnnormalizedLagrangeBasis node (zk_rows=0
    here, so zk_anchored offsets are plain offsets mod n)."""
    offsets: set[int] = set()
    seen: set[int] = set()

    def walk(e):
        if id(e) in seen:
            return
        seen.add(id(e))
        if isinstance(e, expr_mod.UnnormalizedLagrangeBasis):
            offsets.add(e.offset)
        for attr in ("a", "b"):
            child = getattr(e, attr, None)
            if isinstance(child, expr_mod.Expr):
                walk(child)

    for c in constraints:
        walk(c)
    return offsets


def _unnormalized_lagrange_evals(F, constraints, n: int, omega: int, d8, p: int, *, device):
    """d8 evaluations of (x^n - 1)/(x - w^i) for every boundary row the
    constraints reference (expr.rs UnnormalizedLagrangeBasis), on the
    device: (x^n - 1) * batch_inverse(x - w^i) over the d8 points x. The
    point x = w^i is d8's point 8i (w = g8^8); there numerator and
    denominator vanish, batch_inverse gives 0, and the entry is set to the
    removable singularity's value n * w^(-i) (L'Hopital), as the JAX package
    writes it."""
    offsets = _collect_lagrange_offsets(constraints)
    if not offsets:
        return None
    g8, n8 = d8.group_gen, d8.n
    if pow(g8, 8, p) != omega:
        raise ValueError("d8's generator is not an 8th root of d1's")
    x8 = poly.powers_dev(F, g8, n8, device=device)
    # x^n cycles through the 8th roots of unity xi^k: one period, repeated
    xi = pow(g8, n, p)
    period = F.pack_mont([(pow(xi, k, p) - 1) % p for k in range(8)], shape=(8,), device=device)
    num = period.repeat(1, n8 // 8)
    out = {}
    for i in sorted(offsets):
        i %= n
        wi = pow(omega, i, p)
        den = limb.sub(F, x8, F.const_mont(wi, (1,), device=device))
        vals = limb.mont_mul(F, num, limb.batch_inverse(F, den))
        vals[:, 8 * i] = F.const_mont(n * pow(wi, p - 2, p) % p, (), device=device)
        out[i] = vals
    return out


@dataclass
class ColumnProof:
    commitments: list[PolyComm]
    zeta_evaluations: list[int]
    zeta_omega_evaluations: list[int]
    quotient_commitment: PolyComm
    quotient_evaluations: tuple[list[int], list[int]]  # (zeta chunks, zeta_omega)
    opening: OpeningProof


def prove_columns(
    domain, srs, curve: CurveParams, columns_evals: torch.Tensor, constraints, rng,
    make_beta_columns=None, with_joint_combiner: bool = False,
    quotient_numerator=None, device=None,
) -> ColumnProof:
    """columns_evals: (8, C, n) Montgomery evaluations over d1, on `device`
    (the card unless the caller passes device="cpu"), where `domain` and
    `srs` live too.

    Two-phase flow (o1vm/src/pickles/lookup_prover.rs capability): when
    `make_beta_columns` is given, the phase-1 columns above are committed
    and absorbed first, a beta challenge is squeezed (endo-expanded), and
    `make_beta_columns(beta) -> (8, C2, n)` supplies challenge-dependent
    columns (e.g. the LogUp aggregator phi). Constraints may then
    reference Challenge("beta").

    `with_joint_combiner`: squeeze a vector-lookup combiner BEFORE beta
    (msm/src/logup.rs:646-649 order) and call
    `make_beta_columns(beta, joint)`; Challenge("joint_combiner") is then
    bound in the constraint context.

    `quotient_numerator(evals8, ctx) -> (8, 8n)`: a class-batched evaluator
    of the combined constraint over d8 (for circuits with thousands of
    same-shape constraints). It must equal combine_constraints(...)
    exactly: the verifier recomputes that AST at zeta."""
    dev = resolve_device(device)
    check_device(columns_evals, dev, "the columns")
    if torch.device(srs.device).type != dev.type:
        raise ValueError(f"the SRS is on {srs.device}, expected {dev}")
    f = curve.scalar
    p = f.p
    F = limb.device_field(f)
    d1 = domain.d1
    d8 = domain.d8
    n = d1.n
    _, endo_r = curve.endos

    coeffs = intt_columns(d1, columns_evals)  # (8, C, n)
    comms_nh = srs.commit_coeffs_dev(coeffs, 1)
    comms = [srs.mask(c, [1]) for c in comms_nh]

    fq_sponge = sponge_for(curve)
    for c in comms:
        fq_sponge.absorb_g(c.chunks)

    beta = 0
    joint = 0
    if make_beta_columns is not None:
        if with_joint_combiner:
            joint = fq_sponge.challenge().to_field(endo_r, f)
        beta = fq_sponge.challenge().to_field(endo_r, f)
        extra_evals = (
            make_beta_columns(beta, joint)
            if with_joint_combiner
            else make_beta_columns(beta)
        )
        check_device(extra_evals, dev, "the beta columns")
        extra_coeffs = intt_columns(d1, extra_evals)
        extra_nh = srs.commit_coeffs_dev(extra_coeffs, 1)
        extra_comms = [srs.mask(c, [1]) for c in extra_nh]
        for c in extra_comms:
            fq_sponge.absorb_g(c.chunks)
        coeffs = torch.cat([coeffs, extra_coeffs], dim=1)
        comms = comms + extra_comms
    ncols = coeffs.shape[1]

    alpha = fq_sponge.challenge().value  # RAW 128-bit (prover.rs:230)

    evals8 = d8_columns(d8, coeffs)
    columns = {col(i): evals8[:, i] for i in range(ncols)}
    ctx = expr_mod.DeviceEvalContext(
        F=F,
        columns=columns,
        challenges={"alpha": alpha, "beta": beta, "gamma": 0, "joint_combiner": joint},
        endo=endo_r,
        mds=[],
        domain_n=n,
        zk_rows=0,
        omega=d1.group_gen,
        unnormalized_lagrange=_unnormalized_lagrange_evals(
            F, constraints, n, d1.group_gen, d8, p, device=dev
        ),
    )
    if quotient_numerator is not None:
        numerator8 = quotient_numerator(evals8, ctx)  # (8, 8n)
    else:
        combined = expr_mod.combine_constraints(
            range(len(constraints)), list(constraints)
        )
        numerator8 = expr_mod.eval_dev(combined, ctx)  # (8, 8n)
    del ctx, columns, evals8
    num_coeffs = d8.intt(numerator8)
    quotient, rem = poly.divide_by_vanishing(F, num_coeffs, n)

    if not bool(limb.is_zero(F, rem).all()):  # one read from the device
        raise ValueError("constraints not satisfied: quotient remainder non-zero")

    t_comm_nh = srs.commit_coeffs_dev(
        quotient[:, None, :], DEGREE_QUOTIENT_POLYNOMIAL
    )[0]
    t_comm = srs.mask(t_comm_nh, [1] * DEGREE_QUOTIENT_POLYNOMIAL)
    fq_sponge.absorb_g(t_comm.chunks)

    zeta = fq_sponge.challenge().to_field(endo_r, f)
    zeta_omega = zeta * d1.group_gen % p

    pow_z = poly.powers_dev(F, zeta, n, device=dev)
    pow_zw = poly.powers_dev(F, zeta_omega, n, device=dev)
    ev_z, ev_zw = poly.eval_at2(F, coeffs, pow_z, pow_zw)

    tq = quotient.reshape(NLIMBS, DEGREE_QUOTIENT_POLYNOMIAL, n)
    q_z, q_zw = poly.eval_at2(F, tq, pow_z, pow_zw)

    fq_sponge_before = fq_sponge.clone()
    fr_sponge = fr_sponge_for(f)
    fr_sponge.absorb(fq_sponge.digest())
    for a, b in zip(ev_z, ev_zw):
        fr_sponge.absorb(a)
        fr_sponge.absorb(b)
    for a, b in zip(q_z, q_zw):
        fr_sponge.absorb(a)
        fr_sponge.absorb(b)
    v = fr_sponge.challenge().to_field(endo_r, f)
    u = fr_sponge.challenge().to_field(endo_r, f)

    plnms = [(coeffs[:, i], [1]) for i in range(ncols)]
    plnms.append((quotient, [1] * DEGREE_QUOTIENT_POLYNOMIAL))

    opening = open_proof(srs, plnms, [zeta, zeta_omega], v, u, fq_sponge_before, rng)

    return ColumnProof(
        commitments=comms,
        zeta_evaluations=ev_z,
        zeta_omega_evaluations=ev_zw,
        quotient_commitment=t_comm,
        quotient_evaluations=(q_z, q_zw),
        opening=opening,
    )


def pinned_columns_match(domain, srs, proof: ColumnProof, pinned: dict, device) -> bool:
    """Whether the proof's commitments at the pinned indices are those of
    the public columns `pinned` (index -> values over d1), recommitted in
    one commit on `device` with the blinder 1 that prove_columns' hiding
    uses: how a verifier pins fixed tables, selectors and boundary rows."""
    idx = list(pinned)
    F = limb.device_field(srs.curve.scalar)
    packed = F.pack_mont([v for i in idx for v in pinned[i]], shape=(len(idx), domain.d1.n),
                         device=device)
    comms = srs.commit_coeffs_dev(intt_columns(domain.d1, packed), 1)
    return all(proof.commitments[i].chunks == srs.mask(c, [1]).chunks for i, c in zip(idx, comms))


def verify_columns(
    domain, srs, curve: CurveParams, constraints, proof: ColumnProof, rng,
    num_beta_columns: int = 0, with_joint_combiner: bool = False,
) -> bool:
    """`num_beta_columns`: trailing commitments that were committed AFTER
    the beta squeeze (two-phase flow; 0 = single-phase).
    `with_joint_combiner`: mirror the prover's extra pre-beta squeeze.
    The IPA check runs on the SRS's device."""
    f = curve.scalar
    p = f.p
    d1 = domain.d1
    n = d1.n
    _, endo_r = curve.endos

    fq_sponge = sponge_for(curve)
    beta = 0
    joint = 0
    n1 = len(proof.commitments) - num_beta_columns
    for c in proof.commitments[:n1]:
        fq_sponge.absorb_g(c.chunks)
    if num_beta_columns:
        if with_joint_combiner:
            joint = fq_sponge.challenge().to_field(endo_r, f)
        beta = fq_sponge.challenge().to_field(endo_r, f)
        for c in proof.commitments[n1:]:
            fq_sponge.absorb_g(c.chunks)
    alpha = fq_sponge.challenge().value
    fq_sponge.absorb_g(proof.quotient_commitment.chunks)
    zeta = fq_sponge.challenge().to_field(endo_r, f)
    zeta_omega = zeta * d1.group_gen % p

    fq_sponge_before = fq_sponge.clone()
    fr_sponge = fr_sponge_for(f)
    fr_sponge.absorb(fq_sponge.digest())
    for a, b in zip(proof.zeta_evaluations, proof.zeta_omega_evaluations):
        fr_sponge.absorb(a)
        fr_sponge.absorb(b)
    for a, b in zip(*proof.quotient_evaluations):
        fr_sponge.absorb(a)
        fr_sponge.absorb(b)
    v = fr_sponge.challenge().to_field(endo_r, f)
    u = fr_sponge.challenge().to_field(endo_r, f)

    # numerator(zeta) from the claimed evaluations
    def get_cell(c, row):
        i = c[1]
        return (
            proof.zeta_evaluations[i]
            if row == expr_mod.CURR
            else proof.zeta_omega_evaluations[i]
        )

    ctx = expr_mod.HostEvalContext(
        f=f,
        get_cell=get_cell,
        challenges={"alpha": alpha, "beta": beta, "gamma": 0, "joint_combiner": joint},
        endo=endo_r,
        mds=[],
        point=zeta,
        domain_n=n,
        omega=d1.group_gen,
        zk_rows=0,
    )
    combined = expr_mod.combine_constraints(range(len(constraints)), list(constraints))
    numerator_zeta = expr_mod.eval_host(combined, ctx)

    zeta_n = pow(zeta, n, p)
    q_zeta = 0
    zi = 1
    for chunk in proof.quotient_evaluations[0]:
        q_zeta = (q_zeta + zi * chunk) % p
        zi = zi * zeta_n % p
    if q_zeta != numerator_zeta * pow((zeta_n - 1) % p, -1, p) % p:
        return False

    evaluations = [
        Evaluation(c, [[ez], [ezw]])
        for c, ez, ezw in zip(
            proof.commitments, proof.zeta_evaluations, proof.zeta_omega_evaluations
        )
    ]
    evaluations.append(
        Evaluation(
            proof.quotient_commitment,
            [proof.quotient_evaluations[0], proof.quotient_evaluations[1]],
        )
    )
    es = [[[ez], [ezw]] for ez, ezw in zip(proof.zeta_evaluations, proof.zeta_omega_evaluations)]
    es.append([proof.quotient_evaluations[0], proof.quotient_evaluations[1]])
    cip = combined_inner_product(f, v, u, es)

    batch = BatchEvaluationProof(
        sponge=fq_sponge_before,
        evaluations=evaluations,
        evaluation_points=[zeta, zeta_omega],
        polyscale=v,
        evalscale=u,
        opening=proof.opening,
        combined_inner_product=cip,
    )
    return verify_batch(srs, [batch], rng)
