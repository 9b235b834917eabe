"""IVC over the Pasta cycle with an in-circuit verifier-circuit
(arrabbiata/src/{lib,interpreter,witness}.rs capability), on the card.

Counterpart of proof_systems_tpu/folding/ivc.py, host code copied as it
is. The commitments of each step and fold, and the decider's column proof
per side, run on the device of the two SRSs (folding/arrabbiata.py): Vesta
with scalar field Fp for the even steps, Pallas with Fq for the odd ones.

Per IVC step the circuit is (arrabbiata lib.rs:23-72):
  - one app row computing the step function z_{i+1} = z_i^2
    (interpreter.rs run_app),
  - the verifier circuit: Poseidon-hash the *other* curve side's
    accumulator commitments — 15 column commitments x 2 coordinates = 30
    absorbed values (lib.rs NUMBER_OF_VALUES_TO_ABSORB_PUBLIC_IO), using
    the custom 3_60_0_5_5 Poseidon instance (curve.rs:24-33), 5 full
    rounds per row (interpreter.rs PoseidonFullRound). One absorb row +
    60/5 = 12 permutation rows per rate-2 block; 15 blocks + the final
    output row = 196 rows = VERIFIER_CIRCUIT_SIZE (lib.rs:40).

The Pasta cycle alternation: even steps run over Fp (columns committed
on Vesta, whose point coordinates live in Fq); odd steps run over Fq
(committed on Pallas, coordinates in Fp). Each side's circuit hashes
the opposite side's accumulator commitments natively — no foreign-field
arithmetic, the whole point of the 2-cycle.

Redesign vs the reference: the reference plans per-gadget selectors but
hasn't wired them into folding (interpreter.rs run_ivc FIXME). Here every
row has the SAME constraint set — selectors and
Poseidon round constants are *fixed columns* of the relation, folded
linearly like all columns and pinned by the decider against kappa *
template (kappa = 1 + sum of fold challenges). Uniform rows = one
constraint walk over all rows on the device, no branching —
and the folding stays sound without a selector-degree blowup being
special-cased: constraints are degree <= 6 after selector gating and
the mvpoly machinery homogenises at D = 6.

Layout (NCOLS = 33 columns):
  0..14   witness cells (reference NUMBER_OF_COLUMNS = 15)
          - app row: c0 = z_in, c1 = z_in^2 = z_out
          - absorb row: c0..c2 sponge state, c3 c4 absorbed values
          - poseidon row: c(3q)..c(3q+2) = state after q of this row's
            5 rounds; the 5th round output is the NEXT row's c0..c2
  15      sel_app     (fixed)
  16      sel_absorb  (fixed)
  17      sel_pos     (fixed)
  18..32  rc[15]      (fixed; this row's 5 rounds x 3 round constants)
"""

from __future__ import annotations

from dataclasses import dataclass

from ..circuits import expr as E
from ..curves import Pallas, Vesta
from ..fields import Fp, Fq
from ..poseidon.params import fp_3_60_0_5_5, fq_3_60_0_5_5
from .arrabbiata import FoldingEnv, FoldingScheme, RelaxedInstance

N_WITNESS = 15  # arrabbiata NUMBER_OF_COLUMNS
SEL_APP, SEL_ABS, SEL_POS = 15, 16, 17
RC0 = 18
NCOLS = 33
MAX_DEGREE = 6  # 5 (sbox) + 1 (selector column)

ROUNDS = 60
ROUNDS_PER_ROW = 5
ROWS_PER_PERM = ROUNDS // ROUNDS_PER_ROW  # 12
N_ABSORBS = N_WITNESS  # 15 rate-2 blocks hash 30 coordinates
VERIFIER_CIRCUIT_SIZE = N_ABSORBS * (1 + ROWS_PER_PERM) + 1  # 196 (lib.rs:40)


def _cell(i: int, row=E.CURR) -> E.Expr:
    # integer column ids: FoldingEnv maps Cell columns to mvpoly variables
    # directly; the decider re-tags them for the column prover
    return E.Cell(i, row)


def verifier_circuit_size(n_absorbs: int = N_ABSORBS) -> int:
    return n_absorbs * (1 + ROWS_PER_PERM) + 1


def ivc_constraints(field, params) -> list[E.Expr]:
    """The uniform per-row constraint set (same for every row)."""
    p = field.p
    cons: list[E.Expr] = []
    sel_app, sel_abs, sel_pos = _cell(SEL_APP), _cell(SEL_ABS), _cell(SEL_POS)

    # app: c1 = c0^2 (interpreter.rs run_app)
    cons.append(sel_app * (_cell(1) - _cell(0) * _cell(0)))

    # absorb: next state = state + (0, c3, c4) (interpreter.rs
    # PoseidonSpongeAbsorb: into the last SPONGE_WIDTH-1 elements)
    cons.append(sel_abs * (_cell(0, E.NEXT) - _cell(0)))
    cons.append(sel_abs * (_cell(1, E.NEXT) - (_cell(1) + _cell(3))))
    cons.append(sel_abs * (_cell(2, E.NEXT) - (_cell(2) + _cell(4))))

    # poseidon: 5 full rounds per row; round q maps cells 3q..3q+2 to
    # 3q+3..3q+5 (q = 4 lands on the next row's c0..c2), with this
    # row's rc columns as the round constants
    mds = params.mds
    for q in range(ROUNDS_PER_ROW):
        ins = [_cell(3 * q + i) for i in range(3)]
        if q < ROUNDS_PER_ROW - 1:
            outs = [_cell(3 * q + 3 + i) for i in range(3)]
        else:
            outs = [_cell(i, E.NEXT) for i in range(3)]
        sb = [x * x * x * x * x for x in ins]  # x^5 (curve.rs PERM_SBOX=5)
        for i in range(3):
            acc: E.Expr = E.Literal(0)
            for j in range(3):
                acc = acc + E.Literal(mds[i][j] % p) * sb[j]
            cons.append(sel_pos * (outs[i] - (acc + _cell(RC0 + 3 * q + i))))
    return cons


def _fixed_template(params, n: int, n_absorbs: int = N_ABSORBS) -> list[list[int]]:
    """The fixed (structure) columns for an n-row step trace: selectors
    + per-row round constants. Row 0 = app; rows 1.. = verifier circuit;
    the rest noop padding. `n_absorbs` < N_ABSORBS gives a reduced
    verifier circuit (test profile); the full instance hashes all 15
    commitments (2 coordinates each)."""
    cols = [[0] * n for _ in range(NCOLS - N_WITNESS)]
    sel_app = cols[0]
    sel_abs = cols[SEL_ABS - N_WITNESS]
    sel_pos = cols[SEL_POS - N_WITNESS]
    rc = cols[RC0 - N_WITNESS :]
    sel_app[0] = 1
    row = 1
    for _ in range(n_absorbs):
        sel_abs[row] = 1
        row += 1
        for block in range(ROWS_PER_PERM):
            sel_pos[row] = 1
            for q in range(ROUNDS_PER_ROW):
                rnd = params.round_constants[block * ROUNDS_PER_ROW + q]
                for i in range(3):
                    rc[3 * q + i][row] = rnd[i]
            row += 1
    assert row == verifier_circuit_size(n_absorbs)  # output row has no selector
    return cols


def _perm(params, state: list[int]) -> list[int]:
    """Host golden 3_60_0_5_5 permutation (poseidon/permutation.py)."""
    from ..poseidon.permutation import poseidon_block_cipher_py

    s = list(state)
    poseidon_block_cipher_py(params, s)
    return s


def build_step_trace(
    field, params, z_in: int, absorbed: list[int], n: int
) -> tuple[list[list[int]], int, int]:
    """Witness columns for one step. Returns (columns, z_out, digest).

    `absorbed`: the 2 * n_absorbs coordinates of the other side's
    accumulator commitments (zeros on the base step)."""
    p = field.p
    n_absorbs = len(absorbed) // 2
    cols = [[0] * n for _ in range(N_WITNESS)]
    # app row
    z_out = z_in * z_in % p
    cols[0][0] = z_in % p
    cols[1][0] = z_out
    # verifier circuit rows
    state = [0, 0, 0]
    row = 1
    for b in range(n_absorbs):
        v1, v2 = absorbed[2 * b] % p, absorbed[2 * b + 1] % p
        cols[0][row], cols[1][row], cols[2][row] = state
        cols[3][row], cols[4][row] = v1, v2
        state = [state[0], (state[1] + v1) % p, (state[2] + v2) % p]
        row += 1
        # 12 permutation rows, 5 rounds each
        from ..poseidon.permutation import full_round

        for blk in range(ROWS_PER_PERM):
            for q in range(ROUNDS_PER_ROW):
                cols[3 * q][row] = state[0]
                cols[3 * q + 1][row] = state[1]
                cols[3 * q + 2][row] = state[2]
                full_round(params, state, blk * ROUNDS_PER_ROW + q)
            row += 1
    # final output row: the last permutation's result
    cols[0][row], cols[1][row], cols[2][row] = state
    digest = state[0]
    return cols, z_out, digest


@dataclass
class SideState:
    """One curve side of the cycle."""

    field: object
    curve: object
    params: object
    env: FoldingEnv
    scheme: FoldingScheme
    fixed: list[list[int]]
    acc: RelaxedInstance | None = None
    kappa: int = 0  # fixed-column pinning scalar


class IVC:
    """N-step IVC driver over the Pasta cycle (arrabbiata main.rs
    execute/fold loop, main.rs:112-144)."""

    def __init__(self, srs_vesta, srs_pallas, n: int = 256, rng=None,
                 n_absorbs: int = N_ABSORBS):
        from ..verifier_index import sponge_for

        assert n >= verifier_circuit_size(n_absorbs) + 1
        self.n = n
        self.rng = rng
        self.n_absorbs = n_absorbs
        self.z = 0

        def make_side(field, curve, params):
            cons = ivc_constraints(field, params)
            env = FoldingEnv(field, NCOLS, cons, max_degree=MAX_DEGREE)
            scheme = FoldingScheme(
                env,
                srs_vesta if curve is Vesta else srs_pallas,
                curve,
                lambda c=curve: sponge_for(c),
            )
            return SideState(
                field, curve, params, env, scheme,
                _fixed_template(params, n, n_absorbs),
            )

        # even steps: columns over Fp, committed on Vesta (coords in Fq)
        self.sides = [
            make_side(Fp, Vesta, fp_3_60_0_5_5),
            make_side(Fq, Pallas, fq_3_60_0_5_5),
        ]
        self.digests: list[int] = []

    def _absorbed_coords(self, other: SideState) -> list[int]:
        if other.acc is None or other.acc.comms is None:
            return [0] * (2 * self.n_absorbs)
        out = []
        for c in other.acc.comms[: self.n_absorbs]:
            if c is None:
                out += [0, 0]
            else:
                out += [c[0], c[1]]
        return out

    def step(self, i: int, z_in: int) -> tuple[int, int]:
        """Run IVC step i; returns (z_out, digest)."""
        side = self.sides[i % 2]
        other = self.sides[(i + 1) % 2]
        absorbed = self._absorbed_coords(other)
        wcols, z_out, digest = build_step_trace(
            side.field, side.params, z_in, absorbed, self.n
        )
        cols = wcols + side.fixed
        alpha = (digest + 2) % side.field.p  # step combiner seeded by the hash
        inst = side.env.fresh(cols, alpha)
        assert all(e == 0 for e in inst.error), "step trace unsatisfied"
        side.scheme.commit_instance(inst, self.rng)
        if side.acc is None:
            side.acc = inst
            side.kappa = 1
        else:
            folded, r, _cts = side.scheme.fold_committed(side.acc, inst, self.rng)
            side.acc = folded
            side.kappa = (side.kappa + r) % side.field.p
        self.digests.append(digest)
        return z_out, digest

    def run(self, z0: int, steps: int) -> int:
        z = z0
        for i in range(steps):
            z, _ = self.step(i, z)
        return z

    # -- decider -----------------------------------------------------------

    def check_fixed_pinning(self, side: SideState) -> bool:
        """Accumulated fixed columns must equal kappa * template."""
        p = side.field.p
        for k, tmpl in enumerate(side.fixed):
            acc_col = side.acc.columns[N_WITNESS + k]
            if any(av != side.kappa * tv % p for av, tv in zip(acc_col, tmpl)):
                return False
        return True

    def decide(self, domain_by_field, rng, proofs: list | None = None) -> bool:
        """Discharge both accumulators (arrabbiata decider/): relaxed
        relation satisfied + commitments open + fixed columns pinned +
        a column proof per side. `proofs`, when given, receives each
        proved side's (proof, constraints) in order."""
        from .arrabbiata import decider_prove, decider_verify

        for side in self.sides:
            if side.acc is None:
                continue
            if not side.env.is_satisfied(side.acc):
                return False
            if not side.scheme.check_commitments(side.acc):
                return False
            if not self.check_fixed_pinning(side):
                return False
            domain = domain_by_field[side.field]
            proof, cons = decider_prove(
                side.env, side.acc, domain, side.scheme.srs, side.curve, rng,
                device=side.scheme.srs.device,
            )
            if proofs is not None:
                proofs.append((proof, cons))
            if not decider_verify(
                side.env, proof, cons, domain, side.scheme.srs, side.curve, rng
            ):
                return False
        return True
