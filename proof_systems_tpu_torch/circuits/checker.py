"""Host witness checker: evaluates every gate's constraints row by row.

Equivalent of the reference's debug pre-verification
(ConstraintSystem::verify, constraints.rs:408; CircuitGate::verify_*,
gate.rs:206) but driven by the same constraint ASTs the prover uses —
so the checker, prover and verifier cannot drift apart.

Counterpart of proof_systems_tpu/circuits/checker.py, host code copied as
it is, with its error messages.
"""

from __future__ import annotations

from . import expr as expr_mod
from .constraints import ConstraintSystem
from .gate import GateType
from .polynomials.gates import GATE_BUILDERS as _BASE_BUILDERS
from .polynomials.optional_gates import OPTIONAL_GATE_BUILDERS

GATE_BUILDERS = {**_BASE_BUILDERS, **OPTIONAL_GATE_BUILDERS}


def check_witness(
    cs: ConstraintSystem,
    witness: list[list[int]],
    mds: list[list[int]],
    public: list[int] | None = None,
) -> None:
    """Raises ValueError at the first violated constraint."""
    f = cs.f
    p = f.p
    n = cs.domain.d1.n

    cs.verify_witness(witness, public or [])

    constraint_cache = {g: GATE_BUILDERS[g](f) for g in GATE_BUILDERS}

    for row, gate in enumerate(cs.gates):
        if gate.typ not in constraint_cache:
            continue
        nxt = (row + 1) % n

        def get_cell(col, r):
            if col[0] == "witness":
                return witness[col[1]][row if r == expr_mod.CURR else nxt]
            if col[0] == "coefficient":
                i = col[1]
                return gate.coeffs[i] % p if i < len(gate.coeffs) else 0
            raise KeyError(col)

        ctx = expr_mod.HostEvalContext(
            f=f,
            get_cell=get_cell,
            challenges={},
            endo=cs.endo,
            mds=mds,
            point=0,
            domain_n=n,
            omega=cs.domain.d1.group_gen,
            zk_rows=cs.zk_rows,
        )
        # public-input rows of the generic gate don't vanish (they cancel
        # against the public polynomial in the quotient)
        if gate.typ == GateType.Generic and row < cs.public:
            continue
        for ci, c in enumerate(constraint_cache[gate.typ]):
            v = expr_mod.eval_host(c, ctx)
            if v != 0:
                raise ValueError(
                    f"constraint {ci} of {gate.typ.name} violated at row {row}: {v}"
                )
