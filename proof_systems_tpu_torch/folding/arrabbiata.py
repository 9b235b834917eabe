"""Nova-style folding / accumulation for high-degree PLONK-ish relations,
with its commitments and decider on the card.

Counterpart of proof_systems_tpu/folding/arrabbiata.py. The relaxed
instances, the cross terms and the fold are the JAX package's host code,
copied as it is. The commitments run on the SRS's device: an instance's
columns and its error column, or a fold's cross-term columns, are packed
together and committed in one batched MSM (srs.commit_coeffs_dev), then
each is masked with its blinder on the host (srs.mask): the same points as
the JAX package's host sum col[j]*G_j + blinder*H. The decider proves
through the port's column prover on that device.

Capability mirror of the arrabbiata crate (arrabbiata/src/{lib,witness,
constraint,setup}.rs): accumulate many executions of a fixed circuit
into one *relaxed* instance, with cross-terms computed via the MVPoly
machinery (mvpoly/src/lib.rs:240-306), then discharge the accumulator
once with the column prover ("decider", arrabbiata/src/decider/).

Relaxed relation (per row j, constraints C_i of max degree D):

    sum_i alpha_i * C_i_hom(w_j, w_{j+1}, u)  ==  err_j

where C_i_hom is the degree-D homogenisation of C_i and each alpha_i is
its own folded variable (a fresh instance uses alpha_i = alpha^i for a
sponge-sampled alpha; after folding the vector is no longer geometric —
see mvpoly lib.rs:306 compute_combined_cross_terms).

Folding instance1 + r * instance2:
    w' = w1 + r w2,   u' = u1 + r u2,   alpha' = alpha1 + r alpha2,
    err'_j = err1_j + sum_{k=1}^{D} r^k ct_k[j] + r^{D+1} err2_j,
and commitments fold homomorphically the same way, which is what makes
the scheme succinct: the verifier only tracks commitments and scalars.

Per-row cross-term evaluation is embarrassingly parallel; the host path
below is the exact golden model (small verifier circuits).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..circuits import expr as E
from ..curves import CurveParams
from ..fields import FieldParams
from ..runtime import resolve_device
from .mvpoly import MVPoly, cross_terms_alpha_vec, to_expr

MAX_DEGREE = 5  # arrabbiata lib.rs:23
MIN_SRS_LOG2_SIZE = 8  # arrabbiata lib.rs:26
NUMBER_OF_COLUMNS = 15  # arrabbiata lib.rs:29


@dataclass
class RelaxedInstance:
    """A relaxed (committed) instance: witness columns, error column,
    homogeniser u and the alpha combiner vector (witness.rs Env fields
    accumulated_program_state / accumulated_committed_state)."""

    columns: list[list[int]]  # ncols x n
    error: list[int]  # n
    u: int
    alphas: list[int]  # one per constraint
    comms: Optional[list] = None  # ncols host affine points
    error_comm: Optional[object] = None
    blinders: Optional[list[int]] = None  # hiding scalars, fold linearly
    error_blinder: int = 0


class FoldingEnv:
    """Folding context for a fixed constraint set over one field.

    constraints: expression-framework ASTs over Cell(col, CURR/NEXT) with
    column indices 0..ncols-1 (degree <= MAX_DEGREE after homogenisation).
    """

    def __init__(
        self,
        f: FieldParams,
        ncols: int,
        constraints: list[E.Expr],
        max_degree: int = MAX_DEGREE,
    ):
        self.f = f
        self.p = f.p
        self.ncols = ncols
        self.max_degree = max_degree
        self.exprs = list(constraints)
        # variables: [curr cols | next cols], wrap-around next row
        self.polys = [
            MVPoly.from_expr(
                c, self.p, 2 * ncols, max_degree, lambda col: col, offset_next_row=ncols
            )
            for c in constraints
        ]
        for poly in self.polys:
            assert poly.degree() <= max_degree, "constraint exceeds MAX_DEGREE"

    # -- instance construction --------------------------------------------

    def _row_vars(self, columns: list[list[int]], j: int) -> list[int]:
        n = len(columns[0])
        jn = (j + 1) % n
        return [c[j] for c in columns] + [c[jn] for c in columns]

    def fresh(self, columns: list[list[int]], alpha: int) -> RelaxedInstance:
        """Wrap a plain witness: u = 1, alphas = powers of alpha, and the
        error column is the (normally zero) combined constraint value."""
        n = len(columns[0])
        alphas = [pow(alpha, i, self.p) for i in range(len(self.polys))]
        err = [0] * n
        for j in range(n):
            v = self._row_vars(columns, j)
            err[j] = sum(
                a * poly.eval(v) for a, poly in zip(alphas, self.polys)
            ) % self.p
        return RelaxedInstance([list(c) for c in columns], err, 1, alphas)

    def is_satisfied(self, inst: RelaxedInstance) -> bool:
        """Check the relaxed relation row by row (decider's core check)."""
        n = len(inst.columns[0])
        for j in range(n):
            v = self._row_vars(inst.columns, j)
            lhs = sum(
                a * poly.homogeneous_eval(v, inst.u)
                for a, poly in zip(inst.alphas, self.polys)
            ) % self.p
            if lhs != inst.error[j]:
                return False
        return True

    # -- folding -----------------------------------------------------------

    def cross_term_columns(
        self, i1: RelaxedInstance, i2: RelaxedInstance
    ) -> list[list[int]]:
        """ct[k-1][j] = r^k cross-term at row j, k = 1..D+1 (the alpha
        vector adds one homogeneous degree, mvpoly lib.rs:260)."""
        n = len(i1.columns[0])
        out = [[0] * n for _ in range(self.max_degree + 1)]
        for j in range(n):
            v1 = self._row_vars(i1.columns, j)
            v2 = self._row_vars(i2.columns, j)
            cts = cross_terms_alpha_vec(
                self.polys, v1, v2, i1.u, i2.u, i1.alphas, i2.alphas
            )
            for k, c in cts.items():
                out[k - 1][j] = c
        return out

    def fold(
        self, i1: RelaxedInstance, i2: RelaxedInstance, r: int,
        cross: Optional[list[list[int]]] = None,
    ) -> RelaxedInstance:
        p = self.p
        if cross is None:
            cross = self.cross_term_columns(i1, i2)
        n = len(i1.columns[0])
        cols = [
            [(a + r * b) % p for a, b in zip(c1, c2)]
            for c1, c2 in zip(i1.columns, i2.columns)
        ]
        rD1 = pow(r, self.max_degree + 1, p)
        err = []
        for j in range(n):
            v = i1.error[j] + rD1 * i2.error[j]
            for k in range(1, self.max_degree + 1):
                v += pow(r, k, p) * cross[k - 1][j]
            err.append(v % p)
        alphas = [(a + r * b) % p for a, b in zip(i1.alphas, i2.alphas)]
        return RelaxedInstance(cols, err, (i1.u + r * i2.u) % p, alphas)


class FoldingScheme:
    """Committed folding over one curve of the Pasta cycle: Fiat-Shamir
    r from the Fq-sponge over the cross-term commitments
    (witness.rs compute_and_update_challenges analogue)."""

    def __init__(self, env: FoldingEnv, srs, curve: CurveParams, sponge_factory):
        self.env = env
        self.srs = srs
        self.curve = curve
        self.sponge_factory = sponge_factory

    def commit_columns(self, cols: list[list[int]], blinders: list[int]) -> list:
        """Hiding Pedersen vector commitments sum col[j]*G_j + blinder*H of
        every column, in one batched MSM on the SRS's device (a column is
        the coefficient row of the commit; the rows past its length weigh
        zero), each masked with its blinder on the host. Linear in (col,
        blinder), which is all folding needs; the decider re-opens columns
        so no polynomial structure is required here."""
        from ..ops import limb

        n = len(cols[0])
        if n > len(self.srs):
            raise ValueError(f"columns of {n} rows over an SRS of {len(self.srs)} points")
        F = limb.device_field(self.curve.scalar)
        packed = F.pack_mont([v for c in cols for v in c], shape=(len(cols), n),
                             device=self.srs.device)
        comms = self.srs.commit_coeffs_dev(packed, 1)
        return [self.srs.mask(c, [b]).chunks[0] for c, b in zip(comms, blinders)]

    def commit_instance(self, inst: RelaxedInstance, rng) -> None:
        p = self.curve.scalar.p
        inst.blinders = [rng.field(p) for _ in inst.columns]
        inst.error_blinder = rng.field(p)
        *inst.comms, inst.error_comm = self.commit_columns(
            [*inst.columns, inst.error], [*inst.blinders, inst.error_blinder])

    def fold_committed(self, i1: RelaxedInstance, i2: RelaxedInstance, rng):
        """Returns (folded instance, r, cross-term commitments)."""
        p = self.env.p
        cross = self.env.cross_term_columns(i1, i2)
        ct_blinders = [rng.field(p) for _ in cross]
        ct_comms = self.commit_columns(cross, ct_blinders)
        sponge = self.sponge_factory()
        for c in [*(i1.comms or []), *(i2.comms or []), *ct_comms]:
            sponge.absorb_g([c])
        r = sponge.squeeze_scalar_challenge_and_expand()
        out = self.env.fold(i1, i2, r, cross)
        # commitments fold homomorphically with the same weights
        if i1.comms is not None and i2.comms is not None:
            cv = self.curve
            out.comms = [
                cv.add(a, cv.scalar_mul(r, b)) for a, b in zip(i1.comms, i2.comms)
            ]
            rD1 = pow(r, self.env.max_degree + 1, p)
            ec = cv.add(i1.error_comm, cv.scalar_mul(rD1, i2.error_comm))
            for k in range(1, self.env.max_degree + 1):
                ec = cv.add(ec, cv.scalar_mul(pow(r, k, p), ct_comms[k - 1]))
            out.error_comm = ec
            out.blinders = [
                (a + r * b) % p for a, b in zip(i1.blinders, i2.blinders)
            ]
            out.error_blinder = (
                i1.error_blinder
                + rD1 * i2.error_blinder
                + sum(
                    pow(r, k, p) * ct_blinders[k - 1]
                    for k in range(1, self.env.max_degree + 1)
                )
            ) % p
        return out, r, ct_comms

    def check_commitments(self, inst: RelaxedInstance) -> bool:
        """Recompute commitments from the opened columns (decider check),
        in one commit."""
        got = self.commit_columns([*inst.columns, inst.error],
                                  [*inst.blinders, inst.error_blinder])
        return got == [*inst.comms, inst.error_comm]


# -- decider ---------------------------------------------------------------


def decider_constraints(env: FoldingEnv, inst: RelaxedInstance) -> list[E.Expr]:
    """The single combined constraint sum_i alpha_i C_i_hom - err as an
    expression over [cols..., err] columns (decider/prover.rs capability:
    discharge the accumulator with one column proof)."""
    from ..o1vm.pickles import col

    def var_expr(i: int) -> E.Expr:
        if i < env.ncols:
            return E.Cell(col(i), E.CURR)
        return E.Cell(col(i - env.ncols), E.NEXT)

    total: E.Expr = E.Literal(0)
    for a, poly in zip(inst.alphas, env.polys):
        hom = to_expr(poly.mul_by_scalar(a), var_expr, u=inst.u)
        total = total + hom
    return [total - E.Cell(col(env.ncols), E.CURR)]


def decider_prove(env: FoldingEnv, inst: RelaxedInstance, domain, srs, curve, rng,
                  device=None):
    """Prove the accumulated relation with the o1vm column prover, on
    `device` (the card unless the caller passes device="cpu"), where
    `domain` and `srs` live too."""
    from ..o1vm.pickles import prove_columns
    from ..ops import limb

    dev = resolve_device(device)
    F = limb.device_field(curve.scalar)
    n = len(inst.columns[0])
    flat = [v for c in inst.columns for v in c] + list(inst.error)
    packed = F.pack_mont(flat, shape=(env.ncols + 1, n), device=dev)
    cons = decider_constraints(env, inst)
    return prove_columns(domain, srs, curve, packed, cons, rng, device=dev), cons


def decider_verify(env: FoldingEnv, proof, cons, domain, srs, curve, rng) -> bool:
    """Verify a decider proof; the IPA check runs on the SRS's device."""
    from ..o1vm.pickles import verify_columns

    return verify_columns(domain, srs, curve, cons, proof, rng)
