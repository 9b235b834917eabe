"""The kimchi verifier (kimchi/src/verifier.rs).

Counterpart of proof_systems_tpu/verifier.py: oracles() replays the
Fiat-Shamir transcript (verifier.rs:126-630), to_batch() builds the
linearization commitment and the evaluation list (verifier.rs:781-1010),
batch_verify() hands one batched check over any number of proofs to the IPA
(poly_commitment/ipa.verify_batch, one MSM on the SRS's device), and verify()
is a batch of one.

The linearization constant term is evaluated at zeta by walking the same
constraint AST the prover used (circuits/expr.eval_host); the berkeley
linearization has no index terms, so f_comm is perm_scalars * sigma_6
(verifier.rs:897-958). Public inputs are evaluated at zeta and zeta*omega
by the barycentric sum over the public rows, and committed from the SRS's
cached Lagrange-basis commitments, which a chunked domain does not have
(ROADMAP Queue 3: the JAX package fails there too).
"""

from __future__ import annotations

from dataclasses import dataclass

from .circuits import expr as expr_mod
from .circuits.gate import COLUMNS, PERMUTS, GateType
from .circuits.lookup import LookupPattern
from .poly_commitment.commitment import (
    PolyComm,
    b_poly,
    combined_inner_product,
    poly_comm_add,
    poly_comm_scale,
)
from .poly_commitment.ipa import BatchEvaluationProof, Evaluation, verify_batch
from .poseidon import ScalarChallenge, fp_kimchi, fq_kimchi
from .proof import SELECTOR_EVALS, ProverProof
from .prover import fr_sponge_for
from .verifier_index import VerifierIndex, sponge_for

# The optional selectors' commitments, in the order of the batch after
# sigma (verifier.rs; the JAX package's verifier.py:353-362).
_OPTIONAL_COMMS = {
    GateType.RangeCheck0: "range_check0_comm",
    GateType.RangeCheck1: "range_check1_comm",
    GateType.ForeignFieldAdd: "foreign_field_add_comm",
    GateType.ForeignFieldMul: "foreign_field_mul_comm",
    GateType.Xor16: "xor_comm",
    GateType.Rot64: "rot_comm",
}
# Evaluations of the lookup columns, by column tag, and of the pattern
# selectors (the `lookup_kind` cells), in LookupPattern's order.
_LOOKUP_EVALS = {
    ("lookup_aggreg",): "lookup_aggregation",
    ("lookup_table",): "lookup_table",
    ("lookup_runtime_table",): "runtime_lookup_table",
    ("lookup_runtime_selector",): "runtime_lookup_table_selector",
}
_LOOKUP_SELECTOR_EVALS = {
    LookupPattern.Xor: "xor_lookup_selector",
    LookupPattern.Lookup: "lookup_gate_lookup_selector",
    LookupPattern.RangeCheck: "range_check_lookup_selector",
    LookupPattern.ForeignFieldMul: "foreign_field_mul_lookup_selector",
}


@dataclass
class Oracles:
    fq_sponge: object
    joint_combiner: int
    beta: int
    gamma: int
    alpha: int
    zeta: int
    v: int
    u: int
    ft_eval0: int
    combined_inner_product: int
    public_evals: list[list[int]]
    zeta1: int
    digest: int


def oracles(
    vk: VerifierIndex, proof: ProverProof, public_comm: PolyComm, public_input: list[int]
) -> Oracles:
    curve = vk.curve
    f = curve.scalar
    p = f.p
    n = vk.domain.n
    _, endo_r = curve.endos
    zk = vk.zk_rows

    fq_sponge = sponge_for(curve)
    fq_sponge.absorb_fq([vk.digest()])
    for rc in proof.prev_challenges:
        fq_sponge.absorb_g(rc.comm.chunks)
    fq_sponge.absorb_g(public_comm.chunks)
    for c in proof.commitments.w_comm:
        fq_sponge.absorb_g(c.chunks)

    joint_combiner = 0
    if vk.lookup_index is not None:
        li = vk.lookup_index
        if li.runtime_tables_selector is not None:
            fq_sponge.absorb_g(proof.commitments.lookup.runtime.chunks)
        jc_pre = fq_sponge.challenge().value if li.joint_lookup_used else 0
        joint_combiner = ScalarChallenge(jc_pre).to_field(endo_r, f)
        for c in proof.commitments.lookup.sorted:
            fq_sponge.absorb_g(c.chunks)

    beta = fq_sponge.challenge().value
    gamma = fq_sponge.challenge().value
    if vk.lookup_index is not None:
        fq_sponge.absorb_g(proof.commitments.lookup.aggreg.chunks)
    fq_sponge.absorb_g(proof.commitments.z_comm.chunks)
    alpha = fq_sponge.challenge().to_field(endo_r, f)
    # quotient has 7*num_chunks chunks (verifier.rs:260 bounds it by
    # chunk_size * 7 with chunk_size = domain / max_poly_size)
    num_chunks = max(1, vk.domain.n // vk.max_poly_size)
    assert len(proof.commitments.t_comm.chunks) <= 7 * num_chunks, "t commitment too long"
    fq_sponge.absorb_g(proof.commitments.t_comm.chunks)
    zeta = fq_sponge.challenge().to_field(endo_r, f)

    digest = fq_sponge.clone().digest()
    fr_sponge = fr_sponge_for(f)
    fr_sponge.absorb(digest)

    prev_sponge = fr_sponge_for(f)
    for rc in proof.prev_challenges:
        prev_sponge.absorb_multiple(rc.chals)
    fr_sponge.absorb(prev_sponge.digest())

    zeta1 = pow(zeta, n, p)
    zetaw = zeta * vk.domain.group_gen % p
    zeta_to_srs = pow(zeta, vk.max_poly_size, p)
    zetaw_to_srs = pow(zetaw, vk.max_poly_size, p)

    # public evaluations from the public input (verifier.rs:332-380)
    if proof.evals.public is not None:
        public_evals = [proof.evals.public.zeta, proof.evals.public.zeta_omega]
    elif public_input is not None:
        if not public_input:
            public_evals = [[0], [0]]
        else:
            # the negated public polynomial sum_i -p_i L_i at zeta and zeta*omega,
            # L_i(x) = w^i (x^n - 1) / (n (x - w^i))
            ws = [pow(vk.domain.group_gen, i, p) for i in range(len(public_input))]
            ev_z = ev_zw = 0
            for pi, w in zip(public_input, ws):
                ev_z = (ev_z - pow(zeta - w, -1, p) * pi * w) % p
                ev_zw = (ev_zw - pow(zetaw - w, -1, p) * pi * w) % p
            size_inv = pow(n, -1, p)
            public_evals = [
                [ev_z * (zeta1 - 1) * size_inv % p],
                [ev_zw * (pow(zetaw, n, p) - 1) * size_inv % p],
            ]
    else:
        raise ValueError("missing public input evaluation")

    fr_sponge.absorb(proof.ft_eval1)
    fr_sponge.absorb_multiple(public_evals[0])
    fr_sponge.absorb_multiple(public_evals[1])
    for pt in proof.evals.ordered_for_fr_sponge():
        fr_sponge.absorb_multiple(pt.zeta)
        fr_sponge.absorb_multiple(pt.zeta_omega)

    v = fr_sponge.challenge().to_field(endo_r, f)
    u = fr_sponge.challenge().to_field(endo_r, f)

    evals = proof.evals.combine(zeta_to_srs, zetaw_to_srs, p)
    vk.alphas.instantiate(alpha, p)
    a0, a1, a2 = vk.alphas.get_alphas("permutation", 3)
    zkpm_zeta = vk.zkpm_eval(zeta)
    zeta1m1 = (zeta1 - 1) % p

    # ft_eval0 (verifier.rs:412-489)
    init = (evals.w[PERMUTS - 1].zeta[0] + gamma) % p * evals.z.zeta_omega[0] % p
    init = init * a0 % p * zkpm_zeta % p
    ft_eval0 = init
    for i in range(PERMUTS - 1):
        ft_eval0 = (
            ft_eval0 * ((beta * evals.s[i].zeta[0] + evals.w[i].zeta[0] + gamma) % p) % p
        )
    # subtract public chunk polynomial evaluated with zeta_to_srs
    pub_at = 0
    for vpub in reversed(public_evals[0]):
        pub_at = (pub_at * zeta_to_srs + vpub) % p
    ft_eval0 = (ft_eval0 - pub_at) % p
    term = a0 * zkpm_zeta % p * evals.z.zeta[0] % p
    for i in range(PERMUTS):
        term = term * ((gamma + beta * zeta % p * vk.shift[i] + evals.w[i].zeta[0]) % p) % p
    ft_eval0 = (ft_eval0 - term) % p
    numerator = (
        (zeta1m1 * a1 % p * ((zeta - vk.zk_w) % p) + zeta1m1 * a2 % p * ((zeta - 1) % p))
        % p
        * ((1 - evals.z.zeta[0]) % p)
        % p
    )
    denominator = pow((zeta - vk.zk_w) % p * ((zeta - 1) % p) % p, -1, p)
    ft_eval0 = (ft_eval0 + numerator * denominator) % p

    # subtract the linearization constant term, evaluated at zeta on the host
    mds_params = fp_kimchi if f.name == "Fp" else fq_kimchi

    def get_cell(col, row):
        if col[0] == "witness":
            pt = evals.w[col[1]]
        elif col[0] == "coefficient":
            pt = evals.coefficients[col[1]]
        elif col == expr_mod.COL_Z:
            pt = evals.z
        elif col in _LOOKUP_EVALS:
            pt = getattr(evals, _LOOKUP_EVALS[col])
        elif col[0] == "lookup_sorted":
            pt = evals.lookup_sorted[col[1]]
        elif col[0] == "lookup_kind":
            pt = getattr(evals, _LOOKUP_SELECTOR_EVALS[LookupPattern(col[1])])
        elif col[0] == "index":
            pt = getattr(evals, SELECTOR_EVALS[GateType(col[1])])
        else:
            raise KeyError(col)
        return pt.zeta[0] if row == expr_mod.CURR else pt.zeta_omega[0]

    ctx = expr_mod.HostEvalContext(
        f=f,
        get_cell=get_cell,
        challenges={"alpha": alpha, "beta": beta, "gamma": gamma,
                    "joint_combiner": joint_combiner},
        endo=vk.endo,
        mds=[list(r) for r in mds_params.mds],
        point=zeta,
        domain_n=n,
        omega=vk.domain.group_gen,
        zk_rows=zk,
    )
    constant_term = expr_mod.eval_host(vk.linearization_expr, ctx)
    ft_eval0 = (ft_eval0 - constant_term) % p

    # combined inner product over the evaluation list (verifier.rs:492-560)
    es: list[list[list[int]]] = []
    for rc in proof.prev_challenges:
        # RecursionChallenge::evals with max_poly_size >= domain: single chunk
        es.append([[b_poly(f, rc.chals, zeta)], [b_poly(f, rc.chals, zetaw)]])
    es.append(list(public_evals))
    es.append([[ft_eval0], [proof.ft_eval1]])
    for pt in proof.evals.ordered_for_commitment_list():
        es.append([pt.zeta, pt.zeta_omega])

    cip = combined_inner_product(f, v, u, es)

    return Oracles(
        fq_sponge=fq_sponge,
        joint_combiner=joint_combiner,
        beta=beta,
        gamma=gamma,
        alpha=alpha,
        zeta=zeta,
        v=v,
        u=u,
        ft_eval0=ft_eval0,
        combined_inner_product=cip,
        public_evals=public_evals,
        zeta1=zeta1,
        digest=digest,
    )


def to_batch(vk: VerifierIndex, proof: ProverProof, public_input: list[int]) -> BatchEvaluationProof:
    curve = vk.curve
    f = curve.scalar
    p = f.p

    # -sum_i p_i * commit(L_i) from the cached Lagrange-basis commitments
    # (verifier.rs:833): m host scalar multiplications. A chunked proof
    # commits the public polynomial with num_chunks chunks, zero beyond the
    # first (verifier.rs:845): pad so the transcript matches.
    num_chunks = max(1, vk.domain.n // vk.max_poly_size)
    acc = None
    if public_input:
        lag = vk.srs.lagrange_commitments(vk.domain, len(public_input))
        for pi, li in zip(public_input, lag):
            acc = curve.add(acc, curve.scalar_mul((-pi) % p, li))
    comm = PolyComm([acc] + [None] * (num_chunks - 1))
    public_comm = vk.srs.mask(comm, [1] * len(comm))

    o = oracles(vk, proof, public_comm, public_input)

    evals = proof.evals.combine(
        pow(o.zeta, vk.max_poly_size, p),
        pow(o.zeta * vk.domain.group_gen % p, vk.max_poly_size, p),
        p,
    )

    # f_comm = perm_scalars * sigma_6  (berkeley: no index terms)
    a0, _a1, _a2 = vk.alphas.get_alphas("permutation", 3)
    zkpm_zeta = vk.zkpm_eval(o.zeta)
    scalar = evals.z.zeta_omega[0] * o.beta % p * a0 % p * zkpm_zeta % p
    for i in range(PERMUTS - 1):
        scalar = (
            scalar
            * ((o.gamma + o.beta * evals.s[i].zeta[0] + evals.w[i].zeta[0]) % p)
            % p
        )
    scalar = (-scalar) % p
    f_comm = poly_comm_scale(curve, vk.sigma_comm[PERMUTS - 1], scalar)

    # ft_comm = chunk(f_comm) - (zeta^n - 1) * chunk(t_comm)
    zeta_to_srs = pow(o.zeta, vk.max_poly_size, p)

    def chunk_commitment(c: PolyComm) -> PolyComm:
        acc = None
        for ch in reversed(c.chunks):
            acc = ch if acc is None else curve.add(curve.scalar_mul(zeta_to_srs, acc), ch)
        return PolyComm([acc])

    chunked_f = chunk_commitment(f_comm)
    chunked_t = chunk_commitment(proof.commitments.t_comm)
    ft_comm = poly_comm_add(
        curve, chunked_f, poly_comm_scale(curve, chunked_t, (-(o.zeta1 - 1)) % p)
    )

    zetaw = o.zeta * vk.domain.group_gen % p
    evaluations = []
    for rc in proof.prev_challenges:
        evaluations.append(
            Evaluation(rc.comm, [[b_poly(f, rc.chals, o.zeta)], [b_poly(f, rc.chals, zetaw)]])
        )
    evaluations.append(Evaluation(public_comm, list(o.public_evals)))
    evaluations.append(Evaluation(ft_comm, [[o.ft_eval0], [proof.ft_eval1]]))

    cols = [
        (proof.commitments.z_comm, proof.evals.z),
        (vk.generic_comm, proof.evals.generic_selector),
        (vk.psm_comm, proof.evals.poseidon_selector),
        (vk.complete_add_comm, proof.evals.complete_add_selector),
        (vk.mul_comm, proof.evals.mul_selector),
        (vk.emul_comm, proof.evals.emul_selector),
        (vk.endomul_scalar_comm, proof.evals.endomul_scalar_selector),
    ]
    cols += [(proof.commitments.w_comm[i], proof.evals.w[i]) for i in range(COLUMNS)]
    cols += [(vk.coefficients_comm[i], proof.evals.coefficients[i]) for i in range(COLUMNS)]
    cols += [(vk.sigma_comm[i], proof.evals.s[i]) for i in range(PERMUTS - 1)]
    for g, comm_attr in _OPTIONAL_COMMS.items():
        if getattr(vk, comm_attr) is not None:
            cols.append((getattr(vk, comm_attr), getattr(proof.evals, SELECTOR_EVALS[g])))
    if vk.lookup_index is not None:
        cols += _lookup_columns(vk, proof, o.joint_combiner)
    for commv, pt in cols:
        evaluations.append(Evaluation(commv, [pt.zeta, pt.zeta_omega]))

    return BatchEvaluationProof(
        sponge=o.fq_sponge,
        evaluations=evaluations,
        evaluation_points=[o.zeta, zetaw],
        polyscale=o.v,
        evalscale=o.u,
        opening=proof.proof,
        combined_inner_product=o.combined_inner_product,
    )


def _lookup_columns(vk: VerifierIndex, proof: ProverProof, joint: int) -> list:
    """to_batch's lookup entries (verifier.rs:985-1050): the sorted columns,
    the aggregation, the combined table sum_i j^i col_i + tid_comb * ids
    (with j times the runtime table added to the second column), the
    runtime table and its selector, and the pattern selectors."""
    curve = vk.curve
    p = curve.scalar.p
    li = vk.lookup_index
    lk = proof.commitments.lookup
    cols = [(c, proof.evals.lookup_sorted[i]) for i, c in enumerate(lk.sorted)]
    cols.append((lk.aggreg, proof.evals.lookup_aggregation))
    tid_comb = pow(joint, li.lookup_info.max_joint_size, p) if li.table_ids is not None else 0
    comb = None
    jpow = 1
    for ci, c in enumerate(li.lookup_table):
        term = poly_comm_scale(curve, c, jpow)
        if ci == 1 and lk.runtime is not None:
            term = poly_comm_add(curve, term, poly_comm_scale(curve, lk.runtime, joint))
        comb = term if comb is None else poly_comm_add(curve, comb, term)
        jpow = jpow * joint % p
    if li.table_ids is not None:
        comb = poly_comm_add(curve, comb, poly_comm_scale(curve, li.table_ids, tid_comb))
    cols.append((comb, proof.evals.lookup_table))
    if li.runtime_tables_selector is not None:
        cols.append((lk.runtime, proof.evals.runtime_lookup_table))
        cols.append((li.runtime_tables_selector, proof.evals.runtime_lookup_table_selector))
    for pat, attr in _LOOKUP_SELECTOR_EVALS.items():
        if pat in li.lookup_selectors:
            cols.append((li.lookup_selectors[pat], getattr(proof.evals, attr)))
    return cols


def verify(vk: VerifierIndex, proof: ProverProof, public_input: list[int], rng) -> bool:
    """One proof: a batch of one."""
    return batch_verify([(vk, proof, public_input)], rng)


def batch_verify(batch, rng) -> bool:
    """(vk, proof, public_input) triples: one to_batch each, then one
    batched IPA check on the SRS of the first (verifier.rs:1093)."""
    proofs = [to_batch(vk, proof, pub) for vk, proof, pub in batch]
    return verify_batch(batch[0][0].srs, proofs, rng)
