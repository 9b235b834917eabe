"""The kimchi prover (kimchi/src/prover.rs:137-1460) on the card.

Counterpart of proof_systems_tpu/prover.py. The protocol order follows
create_recursive exactly; every column-sized computation runs as batched
limb ops on the index's device:
  - witness commit: one batched iNTT and one batched MSM;
  - lookups: the runtime table's commit, the joint combiner, the sorted
    multiset and the aggregation (host integers, circuits/lookup.py), then
    their commits like every other column;
  - permutation z: batched products, a batch inversion and the prefix
    product over n (K12 + K1 when n > 8,192, limb.prefix_mul);
  - quotient: the constraint-AST walk over d8 (circuits/expr.eval_dev) and
    the permutation term, the vanishing division (block suffix sums) and
    the two boundary divisions by X - c (K9);
  - zeta/zeta*omega evaluations: batched dot products;
  - the IPA opening (poly_commitment/ipa.open_proof).

Not ported, by design: the reference's single jax.jit of the quotient and
its traced-argument dict K0 (prover.py:76-99, 257-265), which worked around
the TPU's dispatch latency and a request-size limit of its compile service;
here the walk runs op by op, the lookup columns with the rest. The
data-mesh sharding of the d8 arrays (prover.py:101-133) belongs to the
multi-device port.

Chunked circuits (domain larger than the SRS) carry num_chunks chunks per
commitment; evaluations are chunk lists recombined with powers of
zeta^max_poly_size (prover.rs:194-199, 956-975). Recursion challenges enter
the transcript and the opening as the reference's prev_challenges.

The host synchronises three times, as the reference does: the z_check
fetch, the fetch of the evaluations, and the opening's fetches.
"""

from __future__ import annotations

import torch

from .circuits import expr as expr_mod
from .circuits import lookup as lookup_mod
from .circuits.gate import COLUMNS, PERMUTS
from .ops import limb, poly
from .ops.limb import NLIMBS
from .poly_commitment.commitment import PolyComm, b_poly_coefficients
from .poly_commitment.ipa import open_proof
from .poseidon import FrSponge, ScalarChallenge, fp_kimchi, fq_kimchi
from .proof import (
    LookupCommitments,
    PointEvaluations,
    ProofEvaluations,
    ProverCommitments,
    ProverProof,
    SELECTOR_EVALS,
)
from .prover_index import ALWAYS_ON, ProverIndex, optional_present
from .utils.tracing import checkpoint
from .verifier_index import sponge_for


def fr_sponge_for(f):
    params = fp_kimchi if f.name == "Fp" else fq_kimchi
    return FrSponge(params)


def _quotient_fn(index: ProverIndex):
    """The quotient phase of one index (built once per index): the d8
    extension of the witness and z, the constraint-AST walk, the
    permutation term, the vanishing division and the boundary terms.

    Returns qfn(w_coeffs (8, 15, n), z_coeffs (8, n), public_low (8, n),
    chal {name: (8, 1)}, lookup_in) -> (quotient (8, 7n), remainder (8, n),
    jt_coeff, r1, r2); with lookups, lookup_in holds the sorted, aggregation
    and runtime-table coefficients, and jt_coeff is the combined table's
    coefficients (else None)."""
    if getattr(index, "_qfn", None) is not None:
        return index._qfn
    cs = index.cs
    f = cs.f
    F = limb.device_field(f)
    cd = index.column_data
    dev = index.device
    d1, d8 = cs.domain.d1, cs.domain.d8
    n = d1.n
    zk = cs.zk_rows
    lcs = cs.lookup_cs
    mds_params = fp_kimchi if f.name == "Fp" else fq_kimchi
    perm_exps = index.alphas.get_exponents("permutation", 3)
    one = F.one_mont((1,), device=dev)

    def to_d8(coeffs):
        return d8.ntt_t(torch.nn.functional.pad(coeffs, (0, 7 * n)), d8.fwd_twiddles)

    def qfn(w_coeffs, z_coeffs, public_low, chal, lookup_in=None):
        w8 = to_d8(w_coeffs)
        z8 = to_d8(z_coeffs)
        columns = {expr_mod.col_witness(i): w8[:, i] for i in range(COLUMNS)}
        columns.update(
            {expr_mod.col_coeff(i): cd.coefficients8[:, i] for i in range(COLUMNS)}
        )
        columns[expr_mod.COL_Z] = z8
        for g, sel8 in cd.selector8.items():  # the always-on and the optional present
            columns[expr_mod.col_index(g)] = sel8

        jt_coeff = None
        if lcs is not None:
            # the combined table sum_i j^i col_i + tid_comb * ids (+ j * the
            # runtime table), in coefficient form for the evaluations and
            # over d8 for the walk
            ld = index.lookup_data
            jt8 = None
            jpow = one
            for i in range(ld["table_coeff"].shape[1]):
                term_c = limb.mont_mul(F, ld["table_coeff"][:, i], jpow)
                term_8 = limb.mont_mul(F, ld["table8"][:, i], jpow)
                jt_coeff = term_c if jt_coeff is None else limb.add(F, jt_coeff, term_c)
                jt8 = term_8 if jt8 is None else limb.add(F, jt8, term_8)
                jpow = limb.mont_mul(F, jpow, chal["joint_combiner"])
            if ld["ids_coeff"] is not None:
                jt_coeff = limb.add(
                    F, jt_coeff, limb.mont_mul(F, ld["ids_coeff"], chal["tid_comb"]))
                jt8 = limb.add(F, jt8, limb.mont_mul(F, ld["ids8"], chal["tid_comb"]))
            if lookup_in.get("runtime_coeffs") is not None:
                rt8 = to_d8(lookup_in["runtime_coeffs"])
                jt_coeff = limb.add(
                    F, jt_coeff,
                    limb.mont_mul(F, lookup_in["runtime_coeffs"], chal["joint_combiner"]))
                jt8 = limb.add(F, jt8, limb.mont_mul(F, rt8, chal["joint_combiner"]))
                columns[lookup_mod.COL_LOOKUP_RUNTIME_TABLE] = rt8
                columns[lookup_mod.COL_LOOKUP_RUNTIME_SELECTOR] = ld["runtime_sel8"]
            sorted8 = to_d8(lookup_in["sorted_coeffs"])
            for i in range(sorted8.shape[1]):
                columns[lookup_mod.col_lookup_sorted(i)] = sorted8[:, i]
            columns[lookup_mod.COL_LOOKUP_AGGREG] = to_d8(lookup_in["aggreg_coeffs"])
            columns[lookup_mod.COL_LOOKUP_TABLE] = jt8
            for pat in lcs.info.patterns:
                columns[lookup_mod.col_lookup_kind(pat)] = ld["sel8"][pat]

        ctx = expr_mod.DeviceEvalContext(
            F=F,
            columns=columns,
            challenges=chal,
            endo=cs.endo,
            mds=[list(r) for r in mds_params.mds],
            domain_n=n,
            zk_rows=zk,
            omega=d1.group_gen,
            vanishes_on_zk_and_previous=cd.vanishes_zk_prev8,
        )
        if lcs is not None:

            def unnorm_lagrange(row_idx: int):
                # (x^n - 1) / (x - w^row) over d8
                num = limb.sub(F, limb.mont_pow(F, cd.x_d8, n), one)
                den = limb.sub(F, cd.x_d8, F.const_mont(cs.sid[row_idx], (1,), device=dev))
                return limb.mont_mul(F, num, limb.batch_inverse(F, den))

            ctx.unnormalized_lagrange = {
                0: unnorm_lagrange(0),
                n - zk - 1: unnorm_lagrange(n - zk - 1),
            }
        gate_evals8 = expr_mod.eval_dev(index.linearization_expr, ctx)

        a0 = limb.mont_pow(F, chal["alpha"], perm_exps[0]) if perm_exps[0] else one
        a1 = limb.mont_pow(F, chal["alpha"], perm_exps[1])
        a2 = limb.mont_pow(F, chal["alpha"], perm_exps[2])

        shifts_side = z8
        for i in range(PERMUTS):
            bshift = limb.mont_mul(F, chal["beta"], F.const_mont(cs.shift[i], (1,), device=dev))
            term = limb.add(
                F,
                limb.add(F, w8[:, i], chal["gamma"]),
                limb.mont_mul(F, cd.x_d8, bshift),
            )
            shifts_side = limb.mont_mul(F, shifts_side, term)
        sigmas_side = torch.roll(z8, -8, dims=-1)
        for i in range(PERMUTS):
            term = limb.add(
                F,
                limb.add(F, w8[:, i], chal["gamma"]),
                limb.mont_mul(F, cd.sigma8[:, i], chal["beta"]),
            )
            sigmas_side = limb.mont_mul(F, sigmas_side, term)
        perm8 = limb.mont_mul(
            F,
            limb.mont_mul(F, limb.sub(F, shifts_side, sigmas_side), a0),
            cd.zkpl8,
        )

        t8 = limb.add(F, gate_evals8, perm8)
        del gate_evals8, perm8, shifts_side, sigmas_side, w8, z8, columns
        f_coeffs = d8.intt_t(t8, d8.inv_twiddles)
        f_coeffs[:, :n] = limb.add(F, f_coeffs[:, :n], public_low)
        quotient, rem = poly.divide_by_vanishing(F, f_coeffs, n)

        z_minus_1 = z_coeffs.clone()
        z_minus_1[:, 0:1] = limb.sub(F, z_coeffs[:, 0:1], one)
        bnd1, r1 = poly.divide_by_linear_dev(F, z_minus_1, 1)
        bnd2, r2 = poly.divide_by_linear_dev(F, z_minus_1, cs.sid[n - zk])
        bnd = limb.add(F, limb.mont_mul(F, bnd1, a1), limb.mont_mul(F, bnd2, a2))
        quotient[:, : n - 1] = limb.add(F, quotient[:, : n - 1], bnd)
        return quotient, rem, jt_coeff, r1, r2

    index._qfn = qfn
    return qfn


def create_proof(
    index: ProverIndex,
    witness,
    rng,
    prev_challenges=(),
    debug: dict | None = None,
    runtime_tables=None,
) -> ProverProof:
    """Prove `witness` against `index`: 15 host columns (lists of ints), or
    a packed (8, 15, rows) Montgomery evaluation tensor on the index's
    device (rows <= n - zk_rows, no public inputs, no lookups), as the
    reference accepts both. runtime_tables: (id, second column) pairs in
    the index's runtime-table layout; prev_challenges: RecursionChallenge
    objects."""
    cs = index.cs
    f = cs.f
    p = f.p
    F = limb.device_field(f)
    dev = index.device
    curve = index.curve
    d1 = cs.domain.d1
    n = d1.n
    nc = index.num_chunks
    srs_len = index.max_poly_size
    zk = cs.zk_rows
    _, endo_r = curve.endos

    checkpoint("create_recursive")
    # -- 1. pad witness + randomize zk rows --------------------------------
    # The packed form skips the host's bigint serialization; the zk-row
    # draws come in the same column-major rng order either way.
    if torch.is_tensor(witness):
        assert cs.public == 0, "packed witness requires no public inputs"
        assert cs.lookup_cs is None, "packed witness requires no lookups"
        rows = witness.shape[2]
        assert rows <= n - zk, "no room for zk rows"
        if rows < n:
            witness = torch.cat([witness, F.zeros((COLUMNS, n - rows), device=dev)], dim=-1)
        zk_draws = [rng.field(p) for _ in range(COLUMNS * zk)]
        w_evals_in = witness.clone()
        w_evals_in[:, :, n - zk :] = F.pack_mont(zk_draws, shape=(COLUMNS, zk), device=dev)
        public = []
    else:
        witness = [list(col) for col in witness]
        length_witness = len(witness[0])
        assert length_witness <= n - zk, "no room for zk rows"
        for col in witness:
            col.extend([0] * (n - len(col)))
            for row in range(n - zk, n):
                col[row] = rng.field(p)
        public = witness[0][: cs.public]
        w_evals_in = None

    checkpoint("pad_witness")
    # -- 2. Fq transcript: vk digest, prev challenges ----------------------
    fq_sponge = sponge_for(curve)
    vk = index.verifier_index()
    fq_sponge.absorb_fq([vk.digest()])
    for rc in prev_challenges:
        fq_sponge.absorb_g(rc.comm.chunks)

    # -- 3. public polynomial (negated) ------------------------------------
    if cs.public == 0:
        # zero polynomial: commit = 0*G + 1*H = H per chunk, no MSM
        public_coeffs = F.zeros((1, n), device=dev)
        public_comm = PolyComm([index.srs.h] * nc)
    else:
        public_evals_d1 = [(-x) % p for x in public] + [0] * (n - cs.public)
        public_dev = F.pack_mont(public_evals_d1, shape=(1, n), device=dev)
        public_coeffs = d1.intt_t(public_dev, d1.inv_twiddles)  # (8, 1, n)
        public_comm = index.srs.commit_coeffs_dev(public_coeffs, nc, [[1] * nc])[0]
    fq_sponge.absorb_g(public_comm.chunks)

    checkpoint("set_up_fq_sponge")
    # -- 4. witness commitments (hiding fused into the MSM) -----------------
    if w_evals_in is not None:
        w_evals = w_evals_in
    else:
        flat_w = [v for col in witness for v in col]
        w_evals = F.pack_mont(flat_w, shape=(COLUMNS, n), device=dev)  # (8, 15, n)
    w_coeffs = d1.intt_t(w_evals, d1.inv_twiddles)
    # vec![rand; num_chunks]: ONE sample repeated per chunk (prover.rs:317)
    w_blinders = [[rng.field(p)] * nc for _ in range(COLUMNS)]
    w_comms = index.srs.commit_coeffs_dev(w_coeffs, nc, w_blinders)
    for c in w_comms:
        fq_sponge.absorb_g(c.chunks)

    checkpoint("commit_to_witness_columns")
    # -- 4b. lookup: joint combiner, sorted polynomials --------------------
    lcs = cs.lookup_cs
    lookup_ctx = {}
    if lcs is not None:
        # runtime tables: the id/length layout must match the setup; the
        # contribution vector is committed + absorbed BEFORE the joint
        # combiner squeeze (prover.rs:383-450)
        runtime_d1 = None
        if lcs.runtime_tables_spec is not None:
            given = [(rt[0], len(rt[1])) for rt in (runtime_tables or [])]
            if given != lcs.runtime_tables_spec:
                raise ValueError("runtime tables inconsistent with configuration")
            runtime_d1 = [0] * n
            off = lcs.runtime_table_offset
            for _tid, data in runtime_tables:
                runtime_d1[off : off + len(data)] = [v % p for v in data]
                off += len(data)
            for i in range(n - zk, n):
                runtime_d1[i] = rng.field(p)
            runtime_dev = F.pack_mont(runtime_d1, shape=(1, n), device=dev)
            runtime_coeffs = d1.intt_t(runtime_dev, d1.inv_twiddles)[:, 0]
            runtime_blinder = [rng.field(p) for _ in range(nc)]
            runtime_comm = index.srs.commit_coeffs_dev(
                runtime_coeffs[:, None, :], nc, [runtime_blinder]
            )[0]
            fq_sponge.absorb_g(runtime_comm.chunks)
            lookup_ctx.update(
                runtime_coeffs=runtime_coeffs, runtime_comm=runtime_comm,
                runtime_blinder=runtime_blinder,
            )
        jc_pre = fq_sponge.challenge().value if lcs.info.joint_lookup_used else 0
        joint = ScalarChallenge(jc_pre).to_field(endo_r, f)
        tid_comb = pow(joint, lcs.info.max_joint_size, p) if lcs.table_ids is not None else 0
        table_d1 = lookup_mod.combined_table_d1(lcs, f, joint, tid_comb, runtime_d1)
        sorted_cols = lookup_mod.sorted_multiset(
            lcs, f, cs.gates, witness, joint, tid_comb, table_d1, zk
        )
        sorted_cols = [lookup_mod.zk_patch(f, c, n, zk, rng) for c in sorted_cols]
        nsorted = len(sorted_cols)
        sorted_dev = F.pack_mont(
            [v for col in sorted_cols for v in col], shape=(nsorted, n), device=dev
        )
        sorted_coeffs = d1.intt_t(sorted_dev, d1.inv_twiddles)
        sorted_blinders = [[rng.field(p) for _ in range(nc)] for _ in range(nsorted)]
        sorted_comms = index.srs.commit_coeffs_dev(sorted_coeffs, nc, sorted_blinders)
        for c in sorted_comms:
            fq_sponge.absorb_g(c.chunks)
        lookup_ctx.update(
            joint=joint, tid_comb=tid_comb, table_d1=table_d1, sorted_cols=sorted_cols,
            sorted_coeffs=sorted_coeffs, sorted_comms=sorted_comms,
            sorted_blinders=sorted_blinders,
        )

    # -- 5. beta, gamma (raw 128-bit challenges) ---------------------------
    beta = fq_sponge.challenge().value
    gamma = fq_sponge.challenge().value

    # -- 5b. lookup aggregation --------------------------------------------
    if lcs is not None:
        aggreg = lookup_mod.aggregation(
            lcs, f, cs.gates, witness, lookup_ctx["joint"], lookup_ctx["tid_comb"],
            beta, gamma, lookup_ctx["sorted_cols"], lookup_ctx["table_d1"], zk, rng,
        )
        aggreg_dev = F.pack_mont(aggreg, shape=(1, n), device=dev)
        aggreg_coeffs = d1.intt_t(aggreg_dev, d1.inv_twiddles)
        aggreg_blinder = [rng.field(p) for _ in range(nc)]
        aggreg_comm = index.srs.commit_coeffs_dev(aggreg_coeffs, nc, [aggreg_blinder])[0]
        fq_sponge.absorb_g(aggreg_comm.chunks)
        lookup_ctx.update(
            aggreg_coeffs=aggreg_coeffs[:, 0], aggreg_comm=aggreg_comm,
            aggreg_blinder=aggreg_blinder,
        )

    checkpoint("use_lookup")
    # -- 6. permutation aggregation z --------------------------------------
    # per-circuit constants: packed once per index, not per proof
    zp = getattr(index, "_zperm_dev", None)
    if zp is None:
        zp = (
            F.pack_mont([v for col in cs.sigma_d1 for v in col], shape=(PERMUTS, n), device=dev),
            F.pack_mont(cs.sid, shape=(1, n), device=dev),
            F.pack_mont(cs.shift, shape=(PERMUTS, 1), device=dev),
        )
        index._zperm_dev = zp
    sigma_d1_dev, sid_dev, shift_dev = zp
    beta_m = F.const_mont(beta, (1, 1), device=dev)
    gamma_m = F.const_mont(gamma, (1, 1), device=dev)
    w7 = w_evals[:, :PERMUTS]
    num_f = limb.add(
        F, limb.add(F, w7, limb.mont_mul(F, limb.mont_mul(F, sid_dev, beta_m), shift_dev)), gamma_m
    )
    den_f = limb.add(F, limb.add(F, w7, limb.mont_mul(F, sigma_d1_dev, beta_m)), gamma_m)

    def prod_rows(x):  # product over the 7 columns -> (8, n)
        acc = x[:, 0]
        for i in range(1, PERMUTS):
            acc = limb.mont_mul(F, acc, x[:, i])
        return acc

    ratio = limb.mont_mul(F, prod_rows(num_f), limb.batch_inverse(F, prod_rows(den_f)))
    pref = limb.prefix_mul(F, ratio)  # P[j] = prod_{k<=j} ratio_k
    z_check = F.unpack_mont(pref[:, n - zk - 1 : n - zk])[0]
    if z_check != 1:
        raise ValueError("permutation argument: final z value is not 1")
    rand1, rand2 = rng.field(p), rng.field(p)
    parts = [
        F.one_mont((1,), device=dev),
        pref[:, : n - zk],  # z[1..n-zk]
        F.pack_mont([rand1, rand2], shape=(2,), device=dev),
    ]
    if zk > 3:
        # rows n-zk+3..n-1 continue the cumulative recurrence from rand2
        # (permutation.rs:546-556 general case)
        anchor_inv = pow(F.unpack_mont(pref[:, n - zk + 1 : n - zk + 2])[0], -1, p)
        scale = F.pack_mont([rand2 * anchor_inv % p], shape=(1,), device=dev)
        parts.append(limb.mont_mul(F, pref[:, n - zk + 2 : n - 1], scale))
    z_evals = torch.cat(parts, dim=-1)[:, :n]
    z_coeffs = d1.intt_t(z_evals, d1.inv_twiddles)
    z_blinder = [rng.field(p) for _ in range(nc)]
    z_comm = index.srs.commit_coeffs_dev(z_coeffs[:, None, :], nc, [z_blinder])[0]
    fq_sponge.absorb_g(z_comm.chunks)

    checkpoint("z_permutation_aggregation_polynomial")
    # -- 7. alpha ----------------------------------------------------------
    alpha = fq_sponge.challenge().to_field(endo_r, f)
    index.alphas.instantiate(alpha, p)

    checkpoint("eval_witness_polynomials_over_domains")
    # -- 8. quotient ---------------------------------------------------------
    cd = index.column_data
    chal = {
        name: F.pack_mont([v], shape=(1,), device=dev)
        for name, v in (
            ("alpha", alpha), ("beta", beta), ("gamma", gamma),
            ("joint_combiner", lookup_ctx.get("joint", 0)),
            ("tid_comb", lookup_ctx.get("tid_comb", 0)),
        )
    }
    lookup_in = None
    if lcs is not None:
        lookup_in = {
            "sorted_coeffs": lookup_ctx["sorted_coeffs"],
            "aggreg_coeffs": lookup_ctx["aggreg_coeffs"],
            "runtime_coeffs": lookup_ctx.get("runtime_coeffs"),
        }
    checkpoint("compute_quotient_poly")
    quotient, rem, jt_coeff, _, _ = _quotient_fn(index)(
        w_coeffs, z_coeffs, public_coeffs[:, 0], chal, lookup_in
    )
    if debug is not None:
        debug["quotient_rem_zero"] = bool(limb.is_zero(F, rem).all())
    a0, a1, a2 = index.alphas.get_alphas("permutation", 3)

    checkpoint("commit_quotient")
    t_nchunks = max(-(-quotient.shape[-1] // srs_len), 7 * nc)
    t_blinders = [rng.field(p) for _ in range(t_nchunks)]
    t_comm = index.srs.commit_coeffs_dev(quotient[:, None, :], 7 * nc, [t_blinders])[0]
    fq_sponge.absorb_g(t_comm.chunks)

    checkpoint("lagrange_basis_eval_zeta_poly")
    # -- 10. zeta + evaluations ---------------------------------------------
    zeta = fq_sponge.challenge().to_field(endo_r, f)
    omega = d1.group_gen
    zeta_omega = zeta * omega % p

    pow_z = poly.powers_dev(F, zeta, srs_len, device=dev)
    pow_zw = poly.powers_dev(F, zeta_omega, srs_len, device=dev)

    # batched coefficient stack: [public, z, w x15, s x6, coeff x15, sel x6,
    # the optional selectors present (rows 44 .. 44 + n_opt - 1), then the
    # lookup columns: sorted, aggregation, table, runtime table and its
    # selector, pattern selectors]
    opt_present = optional_present(cs)
    n_opt = len(opt_present)
    parts = [
        public_coeffs,  # 1
        z_coeffs[:, None, :],  # 1
        w_coeffs,  # 15
        cd.sigma_coeff[:, : PERMUTS - 1],  # 6
        cd.coefficients_coeff,  # 15
        torch.stack([cd.selector_coeff[g] for g in ALWAYS_ON + opt_present], dim=1),  # 6 + n_opt
    ]
    if lcs is not None:
        ld = index.lookup_data
        has_runtime = "runtime_coeffs" in lookup_ctx
        lk_stack = [lookup_ctx["aggreg_coeffs"], jt_coeff]
        if has_runtime:
            lk_stack += [lookup_ctx["runtime_coeffs"], ld["runtime_sel_coeff"]]
        lk_pats = list(lcs.info.patterns)
        lk_stack += [ld["sel_coeff"][pat] for pat in lk_pats]
        parts += [lookup_ctx["sorted_coeffs"], torch.stack(lk_stack, dim=1)]
    stack = torch.cat(parts, dim=1)  # (8, 44 + n_opt + lookup columns, n)
    chunked = stack.reshape(NLIMBS, stack.shape[1] * nc, srs_len)
    ev_z, ev_zw = poly.eval_at2(F, chunked, pow_z, pow_zw)

    def pe(i: int) -> PointEvaluations:
        return PointEvaluations(ev_z[i * nc : (i + 1) * nc], ev_zw[i * nc : (i + 1) * nc])

    evals = ProofEvaluations(
        public=pe(0),
        z=pe(1),
        w=[pe(2 + i) for i in range(15)],
        s=[pe(17 + i) for i in range(6)],
        coefficients=[pe(23 + i) for i in range(15)],
        generic_selector=pe(38),
        poseidon_selector=pe(39),
        complete_add_selector=pe(40),
        mul_selector=pe(41),
        emul_selector=pe(42),
        endomul_scalar_selector=pe(43),
    )
    for i, g in enumerate(opt_present):
        setattr(evals, SELECTOR_EVALS[g], pe(44 + i))
    if lcs is not None:
        ns = len(lookup_ctx["sorted_cols"])
        evals.lookup_sorted = [pe(44 + n_opt + i) for i in range(ns)] + [None] * (5 - ns)
        evals.lookup_aggregation = pe(44 + n_opt + ns)
        evals.lookup_table = pe(45 + n_opt + ns)
        base = 46 + n_opt + ns
        if has_runtime:
            evals.runtime_lookup_table = pe(base)
            evals.runtime_lookup_table_selector = pe(base + 1)
            base += 2
        sel_evals = {pat: pe(base + i) for i, pat in enumerate(lk_pats)}
        evals.xor_lookup_selector = sel_evals.get(lookup_mod.LookupPattern.Xor)
        evals.lookup_gate_lookup_selector = sel_evals.get(lookup_mod.LookupPattern.Lookup)
        evals.range_check_lookup_selector = sel_evals.get(lookup_mod.LookupPattern.RangeCheck)
        evals.foreign_field_mul_lookup_selector = sel_evals.get(
            lookup_mod.LookupPattern.ForeignFieldMul)

    checkpoint("compute_ft_poly")
    # -- 11. ft polynomial (Maller) -----------------------------------------
    zeta_srs = pow(zeta, srs_len, p)
    zeta_n = pow(zeta, n, p)  # zeta_to_domain_size
    combined = evals.combine(zeta_srs, pow(zeta_omega, srs_len, p), p)
    zkpm_zeta = cs.eval_zkpm(zeta)
    perm_scalar = combined.z.zeta_omega[0] * beta % p * a0 % p * zkpm_zeta % p
    for i in range(PERMUTS - 1):
        perm_scalar = (
            perm_scalar
            * ((gamma + beta * combined.s[i].zeta[0] + combined.w[i].zeta[0]) % p)
            % p
        )
    perm_scalar = (-perm_scalar) % p

    f_full = limb.mont_mul(
        F, cd.sigma_coeff[:, PERMUTS - 1], F.const_mont(perm_scalar, (1,), device=dev)
    )  # (8, n)

    def collapse_chunks(arr, nchunks):
        # sum_i zeta^(srs i) chunk_i, padding the last chunk with zeros
        acc = None
        zp_ = 1
        for i in range(nchunks):
            chunk = arr[:, i * srs_len : (i + 1) * srs_len]
            chunk = torch.nn.functional.pad(chunk, (0, srs_len - chunk.shape[-1]))
            term = limb.mont_mul(F, chunk, F.const_mont(zp_, (1,), device=dev))
            acc = term if acc is None else limb.add(F, acc, term)
            zp_ = zp_ * zeta_srs % p
        return acc

    f_lin = collapse_chunks(f_full, nc)
    t_collapsed = collapse_chunks(quotient, len(t_blinders))
    ft_coeffs = limb.sub(
        F, f_lin,
        limb.mont_mul(F, t_collapsed, F.const_mont((zeta_n - 1) % p, (1,), device=dev)),
    )
    # blinding of ft: -(zeta^n - 1) * sum_i zeta^(srs i) w_t_i
    t_blind_collapsed = 0
    zp = 1
    for w_t in t_blinders:
        t_blind_collapsed = (t_blind_collapsed + zp * w_t) % p
        zp = zp * zeta_srs % p
    blinding_ft = (-(zeta_n - 1) * t_blind_collapsed) % p

    ft_eval1 = poly.eval_at(F, ft_coeffs[:, None, :], pow_zw)[0]

    checkpoint("ft_eval_zeta_omega")
    # -- 12. Fr transcript ---------------------------------------------------
    fq_sponge_before_evaluations = fq_sponge.clone()
    fr_sponge = fr_sponge_for(f)
    fr_sponge.absorb(fq_sponge.digest())
    prev_sponge = fr_sponge_for(f)
    for rc in prev_challenges:
        prev_sponge.absorb_multiple(rc.chals)
    fr_sponge.absorb(prev_sponge.digest())
    fr_sponge.absorb(ft_eval1)
    fr_sponge.absorb_multiple(evals.public.zeta)
    fr_sponge.absorb_multiple(evals.public.zeta_omega)
    for pt in evals.ordered_for_fr_sponge():
        fr_sponge.absorb_multiple(pt.zeta)
        fr_sponge.absorb_multiple(pt.zeta_omega)

    v = fr_sponge.challenge().to_field(endo_r, f)
    u = fr_sponge.challenge().to_field(endo_r, f)
    if debug is not None:
        debug.update(beta=beta, gamma=gamma, alpha=alpha, zeta=zeta, v=v, u=u,
                     joint=lookup_ctx.get("joint"), ft_eval1=ft_eval1)

    checkpoint("build_polynomials")
    # -- 13. assemble opening ------------------------------------------------
    plnms = []
    for rc in prev_challenges:
        coeffs = b_poly_coefficients(f, rc.chals)
        plnms.append((F.pack_mont(coeffs, shape=(len(coeffs),), device=dev), [0] * len(rc.comm)))
    plnms.append((public_coeffs[:, 0], [1] * nc))
    plnms.append((ft_coeffs, [blinding_ft]))
    plnms.append((z_coeffs, z_blinder))
    for g in ALWAYS_ON:
        plnms.append((cd.selector_coeff[g], [1] * nc))
    for i in range(COLUMNS):
        plnms.append((w_coeffs[:, i], w_blinders[i]))
    for i in range(COLUMNS):
        plnms.append((cd.coefficients_coeff[:, i], [0] * nc))
    for i in range(PERMUTS - 1):
        plnms.append((cd.sigma_coeff[:, i], [0] * nc))
    for g in opt_present:  # not hiding, as in the verifier index
        plnms.append((cd.selector_coeff[g], [0] * nc))
    if lcs is not None:
        for i in range(len(lookup_ctx["sorted_cols"])):
            plnms.append((lookup_ctx["sorted_coeffs"][:, i], lookup_ctx["sorted_blinders"][i]))
        plnms.append((lookup_ctx["aggreg_coeffs"], lookup_ctx["aggreg_blinder"]))
        # joint table blinding: sum_{i<width} j^i + tid_comb (each column is
        # fixed-hiding in the verifier index; prover.rs:1346-1384)
        width = ld["table_coeff"].shape[1]
        fb = 0
        if width:
            fb = 1  # (1..width).fold(1, |acc,_| 1 + j*acc) = sum_{i<width} j^i
            for _ in range(1, width):
                fb = (1 + lookup_ctx["joint"] * fb) % p
        base_blinding = (fb + lookup_ctx["tid_comb"]) % p
        if has_runtime:
            # table blinder gains j * runtime blinder (prover.rs:1369-1382)
            jt_blinders = [
                (lookup_ctx["joint"] * rb + base_blinding) % p
                for rb in lookup_ctx["runtime_blinder"]
            ]
            plnms.append((jt_coeff, jt_blinders))
            plnms.append((lookup_ctx["runtime_coeffs"], lookup_ctx["runtime_blinder"]))
            plnms.append((ld["runtime_sel_coeff"], [0]))
        else:
            plnms.append((jt_coeff, [base_blinding] * nc))
        for pat in lk_pats:
            plnms.append((ld["sel_coeff"][pat], [0]))

    checkpoint("create_aggregated_ipa")
    opening = open_proof(index.srs, plnms, [zeta, zeta_omega], v, u,
                         fq_sponge_before_evaluations, rng)

    checkpoint("create_recursive_done")
    lookup_comms = None
    if lcs is not None:
        lookup_comms = LookupCommitments(
            sorted=lookup_ctx["sorted_comms"],
            aggreg=lookup_ctx["aggreg_comm"],
            runtime=lookup_ctx.get("runtime_comm"),
        )
    return ProverProof(
        commitments=ProverCommitments(
            w_comm=w_comms, z_comm=z_comm, t_comm=t_comm, lookup=lookup_comms
        ),
        proof=opening,
        evals=evals,
        ft_eval1=ft_eval1,
        prev_challenges=list(prev_challenges),
    )
