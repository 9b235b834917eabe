"""Prover index: device-resident column data and the linearization.

Counterpart of proof_systems_tpu/prover_index.py (kimchi/src/prover_index.rs
ProverIndex::create, :66, and the column precomputation of
constraints.rs:700-770): every indexed column lives as one batched limb
tensor on the SRS's device, in coefficient form (for the evaluations at
zeta) and in d8 evaluation form (for the quotient), made by one batched
iNTT and one batched NTT.

Not ported, by design: the reference's disk cache of the verifier-index
commitments (prover_index.py:210-315), which saved a TPU compile of
minutes; here the b = 28 commit costs about as much as the witness commit.
The selectors of the optional gates a circuit has follow the six always-on
ones in the column batch and in that commit (b = 28 + their count).
The lookup columns (table, table ids, pattern and runtime selectors) are one
more batch of the same iNTT, d8 NTT and commit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .circuits import expr as expr_mod
from .circuits import lookup as lookup_mod
from .circuits.alphas import Alphas, default_alphas
from .circuits.constraints import ConstraintSystem
from .circuits.gate import GateType
from .circuits.polynomials import gates as gate_constraints
from .circuits.polynomials import optional_gates
from .curves import CurveParams, Pallas, Vesta
from .ops import limb, poly
from .verifier_index import LookupVerifierIndex, VerifierIndex

ALWAYS_ON = [
    GateType.Generic,
    GateType.Poseidon,
    GateType.CompleteAdd,
    GateType.VarBaseMul,
    GateType.EndoMul,
    GateType.EndoMulScalar,
]


def optional_present(cs) -> list[GateType]:
    """The optional gates the circuit has, in OPTIONAL_GATE_ORDER: the order
    of their selectors after the always-on ones everywhere (columns, vk
    commit, evaluations, opening)."""
    return [g for g in optional_gates.OPTIONAL_GATE_ORDER if g in cs.selectors_d1]


def build_linearization(f, feature_flags, lookup_cs):
    """Full constraint AST and alpha registry (linearization.rs:43-367;
    constant term only: berkeley index_terms are empty). Each optional gate
    of feature_flags adds index(g) * sum_i alpha^i c_i, in
    OPTIONAL_GATE_ORDER, before the lookup term.

    lookup_cs only needs `.info`, `.table_ids` and `.runtime_selector_d1`
    (a deserialized VerifierIndex passes a shadow object with just those;
    see serialization.deserialize_verifier_index). Returns (alphas,
    linearization_expr)."""
    lookup_constraints = None
    nlookup = 0
    if lookup_cs is not None:
        lookup_constraints = lookup_mod.constraints(lookup_cs, f)
        nlookup = len(lookup_constraints)
    alphas: Alphas = default_alphas(nlookup)
    total = None
    for g in ALWAYS_ON:
        term = gate_constraints.combined(g, f, alphas)
        total = term if total is None else total + term
    for g in optional_gates.OPTIONAL_GATE_ORDER:
        if feature_flags and g in feature_flags:  # None: no optional gate
            constraints = optional_gates.OPTIONAL_GATE_BUILDERS[g](f)
            exps = alphas.get_exponents("gate", len(constraints))
            term = expr_mod.Cell(expr_mod.col_index(g), 0) * expr_mod.combine_constraints(
                exps, constraints
            )
            total = total + term
    if lookup_constraints is not None:
        exps = alphas.get_exponents("lookup", len(lookup_constraints))
        total = total + expr_mod.combine_constraints(exps, lookup_constraints)
    return alphas, total


@dataclass
class ColumnData:
    """Batched device columns (coefficient and d8 evaluation forms)."""

    sigma_coeff: Any  # (8, 7, n)
    sigma8: Any  # (8, 7, 8n)
    coefficients_coeff: Any  # (8, 15, n)
    coefficients8: Any  # (8, 15, 8n)
    selector_coeff: dict  # GateType -> (8, n), ALWAYS_ON then the optional ones present
    selector8: dict  # GateType -> (8, 8n)
    zkpl8: Any  # permutation vanishing poly on d8 (8, 8n)
    vanishes_zk_prev8: Any  # vanishes_on_last_n_rows(zk+1) on d8
    x_d8: Any  # the polynomial x evaluated on d8 (= d8 domain elements)


class ProverIndex:
    def __init__(self, cs: ConstraintSystem, curve: CurveParams, srs):
        """curve: the commitment curve (Vesta for Fp proofs); srs over it.
        The columns live on the SRS's device, as cs's domains must."""
        assert curve.scalar is cs.f
        self.cs = cs
        self.curve = curve
        self.srs = srs
        self.device = srs.device
        if cs.domain.d1.device != self.device:
            raise ValueError(f"domains on {cs.domain.d1.device}, SRS on {self.device}")
        self.max_poly_size = len(srs.g)
        n = cs.domain.d1.n
        self.num_chunks = 1 if n < self.max_poly_size else n // self.max_poly_size
        # endo used in-circuit = endo_q of the *other* curve, which lives in
        # our scalar field (curve.rs other_curve_endo; prover_index.rs:192)
        other = Pallas if curve.name == "Vesta" else Vesta
        cs.endo = other.endos[0]

        self.alphas, self.linearization_expr = build_linearization(
            cs.f, cs.feature_flags, cs.lookup_cs
        )
        self.column_data = self._build_columns()
        self.lookup_data = self._build_lookup_columns()
        self._verifier_index: VerifierIndex | None = None

    # -- column device data ------------------------------------------------

    def _build_columns(self) -> ColumnData:
        cs = self.cs
        f = cs.f
        F = limb.device_field(f)
        dev = self.device
        d1, d8 = cs.domain.d1, cs.domain.d8
        n = d1.n

        sel_order = ALWAYS_ON + optional_present(cs)
        host_cols = cs.sigma_d1 + cs.coefficients_d1 + [cs.selectors_d1[g] for g in sel_order]
        arr = F.pack_mont([v for col in host_cols for v in col], shape=(len(host_cols), n),
                          device=dev)
        coeffs = d1.intt_t(arr, d1.inv_twiddles)
        evals8 = d8.ntt_t(torch.nn.functional.pad(coeffs, (0, 7 * n)), d8.fwd_twiddles)

        # zk polynomials evaluated on d8 from the d8 element vector
        x_d8 = poly.powers_dev(F, d8.group_gen, d8.n, device=dev)
        omega = d1.group_gen

        def prod_of_linear(roots: list[int]):
            acc = None
            for r in roots:
                term = limb.sub(F, x_d8, F.const_mont(r, (1,), device=dev))
                acc = term if acc is None else limb.mont_mul(F, acc, term)
            return acc

        zk = cs.zk_rows
        zkpl_roots = [
            pow(omega, n - zk, f.p),
            pow(omega, n - zk + 1, f.p),
            pow(omega, n - 1, f.p),
        ]
        vzp_roots = [pow(omega, n - (zk + 1) + i, f.p) for i in range(zk + 1)]

        return ColumnData(
            sigma_coeff=coeffs[:, :7],
            sigma8=evals8[:, :7],
            coefficients_coeff=coeffs[:, 7:22],
            coefficients8=evals8[:, 7:22],
            selector_coeff={g: coeffs[:, 22 + i] for i, g in enumerate(sel_order)},
            selector8={g: evals8[:, 22 + i] for i, g in enumerate(sel_order)},
            zkpl8=prod_of_linear(zkpl_roots),
            vanishes_zk_prev8=prod_of_linear(vzp_roots),
            x_d8=x_d8,
        )

    def _build_lookup_columns(self):
        """The lookup columns (the table's columns, its ids, one selector a
        pattern, the runtime selector) in coefficient and d8 form, or None
        without lookups."""
        lcs = self.cs.lookup_cs
        if lcs is None:
            return None
        F = limb.device_field(self.cs.f)
        d1, d8 = self.cs.domain.d1, self.cs.domain.d8
        n = d1.n
        cols: list[list[int]] = list(lcs.lookup_table)
        if lcs.table_ids is not None:
            cols = cols + [lcs.table_ids]
        sel_pats = list(lcs.info.patterns)
        cols = cols + [lcs.selectors_d1[pat] for pat in sel_pats]
        has_runtime = lcs.runtime_selector_d1 is not None
        if has_runtime:
            cols = cols + [lcs.runtime_selector_d1]
        arr = F.pack_mont([v for col in cols for v in col], shape=(len(cols), n),
                          device=self.device)
        coeffs = d1.intt_t(arr, d1.inv_twiddles)
        evals8 = d8.ntt_t(torch.nn.functional.pad(coeffs, (0, 7 * n)), d8.fwd_twiddles)
        w = len(lcs.lookup_table)
        has_ids = lcs.table_ids is not None
        off = w + (1 if has_ids else 0)
        return {
            "coeffs": coeffs,  # every column, in the order of the verifier index's commit
            "table_coeff": coeffs[:, :w],
            "table8": evals8[:, :w],
            "ids_coeff": coeffs[:, w] if has_ids else None,
            "ids8": evals8[:, w] if has_ids else None,
            "sel_coeff": {pat: coeffs[:, off + i] for i, pat in enumerate(sel_pats)},
            "sel8": {pat: evals8[:, off + i] for i, pat in enumerate(sel_pats)},
            "runtime_sel_coeff": coeffs[:, off + len(sel_pats)] if has_runtime else None,
            "runtime_sel8": evals8[:, off + len(sel_pats)] if has_runtime else None,
        }

    # -- verifier index ----------------------------------------------------

    def _compute_vk_comms(self) -> tuple[list, dict, "LookupVerifierIndex | None"]:
        """The 28 column commitments (7 sigma, 15 coefficients, 6 selectors)
        and those of the optional selectors present, in one b = 28 + n_opt
        commit; the six always-on selectors are fixed-hiding (+1*H,
        verifier_index.rs:173), the optional ones are not, as in the JAX
        package. Returns them, the optional ones by gate, and the lookup
        index."""
        cd = self.column_data
        opt = optional_present(self.cs)
        all_coeffs = torch.cat(
            [
                cd.sigma_coeff,
                cd.coefficients_coeff,
                torch.stack([cd.selector_coeff[g] for g in ALWAYS_ON + opt], dim=1),
            ],
            dim=1,
        )  # (8, 28 + n_opt, n)
        comms = self.srs.commit_coeffs_dev(all_coeffs, self.num_chunks)
        opt_comms = {g: comms[28 + i] for i, g in enumerate(opt)}
        comms = comms[:28]
        ones = [1] * self.num_chunks
        for i in range(22, 28):
            comms[i] = self.srs.mask(comms[i], ones)
        return comms, opt_comms, self._compute_lookup_vk()

    def _compute_lookup_vk(self) -> LookupVerifierIndex | None:
        """The lookup columns' commitments in one batch; the table's columns
        and ids are fixed-hiding (+1*H), the selectors are not."""
        lcs = self.cs.lookup_cs
        if lcs is None:
            return None
        ld = self.lookup_data
        ones = [1] * self.num_chunks
        ncols = ld["table_coeff"].shape[1]
        sel_pats = list(lcs.info.patterns)
        lcomms = self.srs.commit_coeffs_dev(ld["coeffs"], self.num_chunks)
        table_comms = [self.srs.mask(lcomms[i], ones) for i in range(ncols)]
        idx = ncols
        ids_comm = None
        if ld["ids_coeff"] is not None:
            ids_comm = self.srs.mask(lcomms[idx], ones)
            idx += 1
        sel_comms = {pat: lcomms[idx + i] for i, pat in enumerate(sel_pats)}
        runtime_sel_comm = None
        if ld["runtime_sel_coeff"] is not None:
            runtime_sel_comm = lcomms[idx + len(sel_pats)]
        return LookupVerifierIndex(
            joint_lookup_used=lcs.info.joint_lookup_used,
            lookup_info=lcs.info,
            lookup_table=table_comms,
            table_ids=ids_comm,
            lookup_selectors=sel_comms,
            runtime_tables_selector=runtime_sel_comm,
        )

    def verifier_index(self) -> VerifierIndex:
        if self._verifier_index is None:
            comms, opt_comms, lookup_vk = self._compute_vk_comms()
            self._verifier_index = VerifierIndex(
                curve=self.curve,
                domain=self.cs.domain.d1,
                max_poly_size=self.max_poly_size,
                zk_rows=self.cs.zk_rows,
                public=self.cs.public,
                sigma_comm=comms[:7],
                coefficients_comm=comms[7:22],
                generic_comm=comms[22],
                psm_comm=comms[23],
                complete_add_comm=comms[24],
                mul_comm=comms[25],
                emul_comm=comms[26],
                endomul_scalar_comm=comms[27],
                shift=self.cs.shift,
                endo=self.cs.endo,
                zkpm_eval=self.cs.eval_zkpm,
                srs=self.srs,
                linearization_expr=self.linearization_expr,
                alphas=self.alphas,
                zk_w=self.cs.zk_w(),
                lookup_index=lookup_vk,
                range_check0_comm=opt_comms.get(GateType.RangeCheck0),
                range_check1_comm=opt_comms.get(GateType.RangeCheck1),
                foreign_field_add_comm=opt_comms.get(GateType.ForeignFieldAdd),
                foreign_field_mul_comm=opt_comms.get(GateType.ForeignFieldMul),
                xor_comm=opt_comms.get(GateType.Xor16),
                rot_comm=opt_comms.get(GateType.Rot64),
            )
        return self._verifier_index
