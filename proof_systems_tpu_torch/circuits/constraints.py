"""Constraint system construction (kimchi/src/circuits/constraints.rs).

Counterpart of proof_systems_tpu/circuits/constraints.py, host code as
there, with the domains' plans on one device.

Builds, from a gate list:
  - the d1..d8 domains with the zk_rows/domain-size fixpoint
    (constraints.rs:984-1000; zk_rows = (16c + 5)/7 for c chunks), where
    the lookup tables' length also bounds the domain,
  - the permutation shifts (blake2b-sampled quadratic non-residues,
    permutation.rs:125-196) and σ columns from the wire cycles
    (constraints.rs:525-560, incl. the zk-row zeroing),
  - selector and coefficient columns (constraints.rs:565-600), an optional
    gate's selector only where the circuit has that gate, which also sets
    its feature flag,
  - the lookup constraint system of fixed and runtime tables.

All columns are produced as host int vectors here; ProverIndex lifts
them to device arrays.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..fields import FieldParams
from .domains import EvaluationDomains, domain_size
from .gate import COLUMNS, PERMUTS, CircuitGate, GateType
from .lookup import LookupConstraintSystem, LookupInfo, LookupTable
from .polynomials.optional_gates import OPTIONAL_GATE_ORDER


def zk_rows_strict_lower_bound(num_chunks: int) -> int:
    return (2 * (PERMUTS + 1) * num_chunks - 2) // PERMUTS


def sample_shifts(f: FieldParams, n: int, omega: int) -> list[int]:
    """Blake2b-derived coset shifts: QNR, outside the domain, distinct
    (permutation.rs:139-196)."""
    shifts = [1]
    counter = 7

    def sample() -> int:
        nonlocal counter
        while True:
            counter += 1
            h = hashlib.blake2b(digest_size=64)
            h.update(counter.to_bytes(4, "big"))
            cand = int.from_bytes(h.digest()[:31], "little")
            if f.legendre(cand) == -1 and pow(cand, n, f.p) != 1:
                return cand

    for _ in range(1, PERMUTS):
        s = sample()
        while s in shifts:
            s = sample()
        shifts.append(s)
    return shifts


@dataclass
class ConstraintSystem:
    f: FieldParams
    gates: list[CircuitGate]
    public: int
    domain: EvaluationDomains
    zk_rows: int
    shift: list[int]
    sid: list[int]  # [omega^i]
    sigma_d1: list[list[int]]  # PERMUTS x n
    selectors_d1: dict[GateType, list[int]]
    coefficients_d1: list[list[int]]  # COLUMNS x n
    feature_flags: set = field(default_factory=set)
    endo: int = 0
    lookup_cs: "LookupConstraintSystem | None" = None

    @classmethod
    def create(
        cls,
        f: FieldParams,
        gates: list[CircuitGate],
        public: int = 0,
        max_poly_size: int | None = None,
        fixed_lookup_tables: "list[LookupTable] | None" = None,
        runtime_tables=None,
        device=None,
    ) -> "ConstraintSystem":
        """The constraint system of `gates`; its domains' plans live on
        `device` (the CUDA card unless device="cpu")."""
        assert gates, "empty gate list"
        # lookup table length drives the domain fixpoint (constraints.rs:940-960)
        lookup_domain_size = 0
        info = LookupInfo.from_gates(gates, uses_runtime_tables=runtime_tables is not None)
        if info is not None or fixed_lookup_tables:
            seen = set()
            total = 0
            has_id_0 = False
            for t in fixed_lookup_tables or []:
                seen.add(t.id)
                total += len(t)
                has_id_0 |= t.id == 0
            if info is not None:
                for pat in info.patterns:
                    t = pat.table()
                    if t is not None and t.id not in seen:
                        seen.add(t.id)
                        total += len(t)
                        has_id_0 |= t.id == 0
            for rt in runtime_tables or []:
                total += len(rt)
            lookup_domain_size = total if has_id_0 else total + 1

        circuit_lower_bound = max(len(gates), lookup_domain_size + 1)
        zk_rows = 3
        n = domain_size(circuit_lower_bound + zk_rows)
        if max_poly_size is not None:
            while True:
                num_chunks = 1 if n < max_poly_size else n // max_poly_size
                zk_rows = zk_rows_strict_lower_bound(num_chunks) + 1
                lower = circuit_lower_bound + zk_rows
                if n >= lower:
                    break
                n = domain_size(lower)

        domain = EvaluationDomains.create(f, n, device)
        n = domain.d1.n

        # pad with Zero gates (self-wired)
        gates = list(gates)
        for row in range(len(gates), n):
            gates.append(CircuitGate.zero(row))

        omega = domain.d1.group_gen
        sid = [1] * n
        for i in range(1, n):
            sid[i] = sid[i - 1] * omega % f.p

        shifts = sample_shifts(f, n, omega)

        # sigma columns from wire cycles: sigma[col][row] = shift[w.col]*omega^w.row
        sigma = [[0] * n for _ in range(PERMUTS)]
        for row, gate in enumerate(gates):
            for col in range(PERMUTS):
                w = gate.wires[col]
                sigma[col][row] = shifts[w.col] * sid[w.row] % f.p
        # zero out zk rows (constraints.rs:538-545)
        for row in range(n + 2 - zk_rows, n - 1):
            for col in range(PERMUTS):
                sigma[col][row] = 0

        # selectors
        always_on = [
            GateType.Generic,
            GateType.Poseidon,
            GateType.CompleteAdd,
            GateType.VarBaseMul,
            GateType.EndoMul,
            GateType.EndoMulScalar,
        ]
        selectors = {g: [0] * n for g in always_on}
        features = set()
        for row, gate in enumerate(gates):
            if gate.typ in selectors:
                selectors[gate.typ][row] = 1
            elif gate.typ in OPTIONAL_GATE_ORDER:
                features.add(gate.typ)
                selectors.setdefault(gate.typ, [0] * n)
                selectors[gate.typ][row] = 1
            elif gate.typ not in (GateType.Zero, GateType.Lookup):
                features.add(gate.typ)

        coefficients = [
            [gate.coeffs[i] % f.p if i < len(gate.coeffs) else 0 for gate in gates]
            for i in range(COLUMNS)
        ]

        lookup_cs = LookupConstraintSystem.create(
            f, gates, n, zk_rows, fixed_lookup_tables, runtime_tables
        ) if (info is not None or fixed_lookup_tables) else None

        return cls(
            f=f,
            gates=gates,
            public=public,
            domain=domain,
            zk_rows=zk_rows,
            shift=shifts,
            sid=sid,
            sigma_d1=sigma,
            selectors_d1=selectors,
            coefficients_d1=coefficients,
            feature_flags=features,
            lookup_cs=lookup_cs,
        )

    # -- zk / vanishing helpers (permutation.rs:66-131) -------------------

    def zk_w(self) -> int:
        """omega^(n - zk_rows)."""
        return pow(self.domain.d1.group_gen, self.domain.d1.n - self.zk_rows, self.f.p)

    def eval_vanishes_on_last_n_rows(self, i: int, x: int) -> int:
        f, d = self.f, self.domain.d1
        if i == 0:
            return 1
        term = pow(d.group_gen, d.n - i, f.p)
        acc = (x - term) % f.p
        for _ in range(i - 1):
            term = term * d.group_gen % f.p
            acc = acc * (x - term) % f.p
        return acc

    def eval_zkpm(self, x: int) -> int:
        """permutation_vanishing_polynomial at x (3 roots)."""
        f, d = self.f, self.domain.d1
        term = pow(d.group_gen, d.n - self.zk_rows, f.p)
        acc = (x - term) % f.p
        acc = acc * (x - term * d.group_gen) % f.p
        acc = acc * (x - pow(d.group_gen, d.n - 1, f.p)) % f.p
        return acc

    def verify_witness(self, witness: list[list[int]], public: list[int]) -> None:
        """Debug witness checker: copy constraints + per-gate host checks
        (constraints.rs:408, gate.rs:206). Copy constraints only for now."""
        f = self.f
        for row, gate in enumerate(self.gates):
            for col in range(PERMUTS):
                w = gate.wires[col]
                if witness[col][row] != witness[w.col][w.row]:
                    raise ValueError(
                        f"copy constraint violated at row {row} col {col} -> {w}"
                    )
