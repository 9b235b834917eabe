"""Verifier index (kimchi/src/verifier_index.rs:59-160) and its transcript
digest (verifier_index.rs:397-520).

Counterpart of proof_systems_tpu/verifier_index.py, host code: the lookup
index, the digest over every commitment, and `to_file`/`from_file` in the
JAX package's file format (serialization.py), so that either package reads
the other's files.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .circuits.lookup import LookupPattern
from .curves import CurveParams
from .poly_commitment.commitment import PolyComm
from .poseidon import FqSponge, fp_kimchi, fq_kimchi


def sponge_for(curve: CurveParams) -> FqSponge:
    """The Fq sponge over the curve's base field
    (G::other_curve_sponge_params: fq_kimchi params for Vesta)."""
    params = fq_kimchi if curve.base.name == "Fq" else fp_kimchi
    return FqSponge(params, curve)


@dataclass
class LookupVerifierIndex:
    """verifier_index.rs LookupVerifierIndex: per-column table commitments,
    optional table-id commitment, per-pattern selector commitments."""

    joint_lookup_used: bool
    lookup_info: Any
    lookup_table: list[PolyComm]
    table_ids: Optional[PolyComm]
    lookup_selectors: dict  # LookupPattern -> PolyComm
    runtime_tables_selector: Optional[PolyComm] = None


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
    lookup_index: Optional[LookupVerifierIndex] = None

    def to_file(self, path) -> None:
        """Persist to disk (verifier_index.rs:345). The SRS and derived
        members are rebuilt on load, as in the reference."""
        from .serialization import serialize_verifier_index

        with open(path, "wb") as fh:
            fh.write(serialize_verifier_index(self))

    @staticmethod
    def from_file(path, srs) -> "VerifierIndex":
        """Load from disk against a live SRS (verifier_index.rs:384); the
        domain's plan lives on the SRS's device."""
        from .serialization import deserialize_verifier_index

        with open(path, "rb") as fh:
            return deserialize_verifier_index(fh.read(), srs)

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
        li = self.lookup_index
        if li is not None:
            comms += [*li.lookup_table, li.table_ids, li.runtime_tables_selector]
            comms += [li.lookup_selectors.get(pat) for pat in LookupPattern]
        for c in comms:
            if c is not None:
                sponge.absorb_g(c.chunks)
        return sponge.digest_fq()
