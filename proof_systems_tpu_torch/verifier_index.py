"""Verifier index (kimchi/src/verifier_index.rs:59-160) and its transcript
digest (verifier_index.rs:397-520).

Counterpart of proof_systems_tpu/verifier_index.py, host code. The lookup
index (ROADMAP Queue 1 item 8) and `to_file`/`from_file` (item 10) are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .curves import CurveParams
from .poly_commitment.commitment import PolyComm
from .poseidon import FqSponge, fp_kimchi, fq_kimchi


def sponge_for(curve: CurveParams) -> FqSponge:
    """The Fq sponge over the curve's base field
    (G::other_curve_sponge_params: fq_kimchi params for Vesta)."""
    params = fq_kimchi if curve.base.name == "Fq" else fp_kimchi
    return FqSponge(params, curve)


@dataclass
class VerifierIndex:
    curve: CurveParams
    domain: Any  # NttPlan (d1)
    max_poly_size: int
    zk_rows: int
    public: int
    sigma_comm: list[PolyComm]  # PERMUTS
    coefficients_comm: list[PolyComm]  # COLUMNS
    generic_comm: PolyComm
    psm_comm: PolyComm
    complete_add_comm: PolyComm
    mul_comm: PolyComm
    emul_comm: PolyComm
    endomul_scalar_comm: PolyComm
    shift: list[int]
    endo: int
    zkpm_eval: Any  # callable x -> permutation vanishing poly at x
    srs: Any
    linearization_expr: Any
    alphas: Any
    zk_w: int  # omega^(n - zk_rows)
    range_check0_comm: Optional[PolyComm] = None
    range_check1_comm: Optional[PolyComm] = None
    foreign_field_add_comm: Optional[PolyComm] = None
    foreign_field_mul_comm: Optional[PolyComm] = None
    xor_comm: Optional[PolyComm] = None
    rot_comm: Optional[PolyComm] = None

    def digest(self) -> int:
        """Absorb every commitment; squeeze one base-field element."""
        sponge = sponge_for(self.curve)
        comms = [
            *self.sigma_comm,
            *self.coefficients_comm,
            self.generic_comm,
            self.psm_comm,
            self.complete_add_comm,
            self.mul_comm,
            self.emul_comm,
            self.endomul_scalar_comm,
            self.range_check0_comm,
            self.range_check1_comm,
            self.foreign_field_mul_comm,  # note: mul before add (verifier_index.rs:468)
            self.foreign_field_add_comm,
            self.xor_comm,
            self.rot_comm,
        ]
        for c in comms:
            if c is not None:
                sponge.absorb_g(c.chunks)
        return sponge.digest_fq()
