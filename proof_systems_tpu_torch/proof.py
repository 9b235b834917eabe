"""Proof structures (kimchi/src/proof.rs).

Counterpart of proof_systems_tpu/proof.py, host code copied as it is.

PointEvaluations / ProofEvaluations mirror proof.rs:33-149; evaluation
values are chunk lists (length num_chunks). The FrSponge absorption
order lives in plonk_sponge_absorb_evaluations (plonk_sponge.rs:55-153)
— protocol-critical, see SURVEY.md Appendix A.8.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .circuits.gate import GateType
from .poly_commitment.commitment import PolyComm
from .poly_commitment.ipa import OpeningProof

# The ProofEvaluations field of each gate's selector: the six always-on
# gates, then the optional ones (set only where the circuit has the gate).
SELECTOR_EVALS = {
    GateType.Generic: "generic_selector",
    GateType.Poseidon: "poseidon_selector",
    GateType.CompleteAdd: "complete_add_selector",
    GateType.VarBaseMul: "mul_selector",
    GateType.EndoMul: "emul_selector",
    GateType.EndoMulScalar: "endomul_scalar_selector",
    GateType.RangeCheck0: "range_check0_selector",
    GateType.RangeCheck1: "range_check1_selector",
    GateType.ForeignFieldAdd: "foreign_field_add_selector",
    GateType.ForeignFieldMul: "foreign_field_mul_selector",
    GateType.Xor16: "xor_selector",
    GateType.Rot64: "rot_selector",
}


@dataclass
class PointEvaluations:
    zeta: list[int]
    zeta_omega: list[int]


@dataclass
class ProofEvaluations:
    public: Optional[PointEvaluations]
    w: list[PointEvaluations]  # COLUMNS
    z: PointEvaluations
    s: list[PointEvaluations]  # PERMUTS - 1
    coefficients: list[PointEvaluations]  # COLUMNS
    generic_selector: PointEvaluations
    poseidon_selector: PointEvaluations
    complete_add_selector: PointEvaluations
    mul_selector: PointEvaluations
    emul_selector: PointEvaluations
    endomul_scalar_selector: PointEvaluations
    # optional gates (None when the feature is off)
    range_check0_selector: Optional[PointEvaluations] = None
    range_check1_selector: Optional[PointEvaluations] = None
    foreign_field_add_selector: Optional[PointEvaluations] = None
    foreign_field_mul_selector: Optional[PointEvaluations] = None
    xor_selector: Optional[PointEvaluations] = None
    rot_selector: Optional[PointEvaluations] = None
    lookup_aggregation: Optional[PointEvaluations] = None
    lookup_table: Optional[PointEvaluations] = None
    lookup_sorted: list[Optional[PointEvaluations]] = field(default_factory=lambda: [None] * 5)
    runtime_lookup_table: Optional[PointEvaluations] = None
    runtime_lookup_table_selector: Optional[PointEvaluations] = None
    xor_lookup_selector: Optional[PointEvaluations] = None
    lookup_gate_lookup_selector: Optional[PointEvaluations] = None
    range_check_lookup_selector: Optional[PointEvaluations] = None
    foreign_field_mul_lookup_selector: Optional[PointEvaluations] = None

    def ordered_for_fr_sponge(self) -> list[PointEvaluations]:
        """plonk_sponge.rs:55-153 absorption order (public excluded)."""
        pts = [
            self.z,
            self.generic_selector,
            self.poseidon_selector,
            self.complete_add_selector,
            self.mul_selector,
            self.emul_selector,
            self.endomul_scalar_selector,
        ]
        pts += self.w
        pts += self.coefficients
        pts += self.s
        for opt in [
            self.range_check0_selector,
            self.range_check1_selector,
            self.foreign_field_add_selector,
            self.foreign_field_mul_selector,
            self.xor_selector,
            self.rot_selector,
            self.lookup_aggregation,
            self.lookup_table,
            *self.lookup_sorted,
            self.runtime_lookup_table,
            self.runtime_lookup_table_selector,
            self.xor_lookup_selector,
            self.lookup_gate_lookup_selector,
            self.range_check_lookup_selector,
            self.foreign_field_mul_lookup_selector,
        ]:
            if opt is not None:
                pts.append(opt)
        return pts

    def ordered_for_commitment_list(self) -> list[PointEvaluations]:
        """The verifier's es / opening-commitment order (verifier.rs:502-560,
        985-1050): like the Fr-sponge order for the non-lookup prefix, but
        lookup columns come as sorted.., aggreg, table, runtime, selectors."""
        pts = [
            self.z,
            self.generic_selector,
            self.poseidon_selector,
            self.complete_add_selector,
            self.mul_selector,
            self.emul_selector,
            self.endomul_scalar_selector,
        ]
        pts += self.w
        pts += self.coefficients
        pts += self.s
        for opt in [
            self.range_check0_selector,
            self.range_check1_selector,
            self.foreign_field_add_selector,
            self.foreign_field_mul_selector,
            self.xor_selector,
            self.rot_selector,
            *self.lookup_sorted,
            self.lookup_aggregation,
            self.lookup_table,
            self.runtime_lookup_table,
            self.runtime_lookup_table_selector,
            self.xor_lookup_selector,
            self.lookup_gate_lookup_selector,
            self.range_check_lookup_selector,
            self.foreign_field_mul_lookup_selector,
        ]:
            if opt is not None:
                pts.append(opt)
        return pts

    def combine(self, zeta_pow_n: int, zeta_omega_pow_n: int, p: int) -> "ProofEvaluations":
        """Collapse chunked evaluations with powers of ζ^max_poly_size
        (proof.rs combine)."""

        def comb(pe: Optional[PointEvaluations]) -> Optional[PointEvaluations]:
            if pe is None:
                return None

            def one(vals, x):
                acc = 0
                for v in reversed(vals):
                    acc = (acc * x + v) % p
                return acc

            return PointEvaluations(
                [one(pe.zeta, zeta_pow_n)], [one(pe.zeta_omega, zeta_omega_pow_n)]
            )

        return ProofEvaluations(
            public=comb(self.public),
            w=[comb(x) for x in self.w],
            z=comb(self.z),
            s=[comb(x) for x in self.s],
            coefficients=[comb(x) for x in self.coefficients],
            generic_selector=comb(self.generic_selector),
            poseidon_selector=comb(self.poseidon_selector),
            complete_add_selector=comb(self.complete_add_selector),
            mul_selector=comb(self.mul_selector),
            emul_selector=comb(self.emul_selector),
            endomul_scalar_selector=comb(self.endomul_scalar_selector),
            range_check0_selector=comb(self.range_check0_selector),
            range_check1_selector=comb(self.range_check1_selector),
            foreign_field_add_selector=comb(self.foreign_field_add_selector),
            foreign_field_mul_selector=comb(self.foreign_field_mul_selector),
            xor_selector=comb(self.xor_selector),
            rot_selector=comb(self.rot_selector),
            lookup_aggregation=comb(self.lookup_aggregation),
            lookup_table=comb(self.lookup_table),
            lookup_sorted=[comb(x) for x in self.lookup_sorted],
            runtime_lookup_table=comb(self.runtime_lookup_table),
            runtime_lookup_table_selector=comb(self.runtime_lookup_table_selector),
            xor_lookup_selector=comb(self.xor_lookup_selector),
            lookup_gate_lookup_selector=comb(self.lookup_gate_lookup_selector),
            range_check_lookup_selector=comb(self.range_check_lookup_selector),
            foreign_field_mul_lookup_selector=comb(self.foreign_field_mul_lookup_selector),
        )


@dataclass
class LookupCommitments:
    sorted: list[PolyComm]
    aggreg: PolyComm
    runtime: Optional[PolyComm] = None


@dataclass
class ProverCommitments:
    w_comm: list[PolyComm]  # COLUMNS
    z_comm: PolyComm
    t_comm: PolyComm
    lookup: Optional[LookupCommitments] = None


@dataclass
class RecursionChallenge:
    chals: list[int]
    comm: PolyComm


@dataclass
class ProverProof:
    commitments: ProverCommitments
    proof: OpeningProof
    evals: ProofEvaluations
    ft_eval1: int
    prev_challenges: list[RecursionChallenge] = field(default_factory=list)
