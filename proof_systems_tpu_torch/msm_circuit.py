"""Foreign-field MSM circuit (msm/ crate: README.md, columns.rs,
circuit_design/, lookups.rs RangeCheck16), on the card.

Counterpart of proof_systems_tpu/msm_circuit.py. The host code (the curve,
the layout, the planner, the witness columns, the lookup specs and the
constraint AST) is the JAX package's, copied as it is; the columns are
packed on the device the caller names (the card unless device="cpu") and
prove through o1vm/pickles.prove_columns with LogUp's phase-2 columns. The
verifier pins the schedule columns (selectors and operand points) in one
recommit (pickles.pinned_columns_match).

Proves "MSM(s, P) = R" for PUBLIC scalars s and points P on a curve
whose base field f is FOREIGN to the proof's native scalar field —
the reference's motivating case is verifying Pallas/Vesta commitments
inside an EVM-friendly field. Field elements ride as N_LIMBS columns of
LIMB_BITS bits each (reference: 16-ish limbs range-checked by a
RangeCheck16 LogUp table, msm/src/lib.rs:42-46; the limb width here is
a parameter so tests can use an 8-bit table on small domains).

Circuit shape (README.md: "the circuit is wide enough to handle one
elliptic curve addition on one row"): each row is one affine EC
operation — sel_add rows compute (x3,y3) = (x1,y1) + (x2,y2), sel_dbl
rows (x3,y3) = 2·(x1,y1) — with the accumulator chained to the next
row (x1' = x3) and the row schedule + operand points derived from the
public (s, P) by the same double-and-add planner the verifier runs.
Three foreign-field checks per row, each an integer identity
LHS = q·f proven by a limb carry chain:

  add:  λ·(x2-x1+4f) + (y1-y2+4f)              = q1·f
        λ·λ + (12f - x1 - x2 - x3)             = q2·f
        λ·(x1-x3+4f) + (8f - y1 - y3)          = q3·f
  dbl:  λ·(2·y1) + (49f² - 3·x1·x1 - a)        = q1·f
        λ·λ + (12f - 2·x1 - x3)                = q2·f
        λ·(x1-x3+4f) + (8f - y1 - y3)          = q3·f

Every parenthesised operand is made non-negative by adding multiples
of f (constants fold into the per-position carry chain), so q ≥ 0 and
its limbs are range-checked; carries are range-checked through a
shifted multi-limb decomposition. λ, x3, y3 are range-checked to
N_LIMBS·LIMB_BITS bits; intermediate accumulator values may be
non-canonical representatives (mod-f arithmetic is representative-
agnostic) — the final row's (x3,y3) is pinned to the canonical public
result R, and row 0's (x1,y1) to the planner's start point.

Witness mode and constraint mode share one interpreter (`_row_checks`
emits either ints or Expr — the circuit_design capability pattern,
msm/src/circuit_design/capabilities.rs).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .circuits import expr as E
from .fields import FieldParams
from .o1vm.logup import FixedTable, LookupSpec, MultiLogup
from .runtime import resolve_device

TBL_RANGE = 1  # msm/src/lookups.rs:75 RangeCheck16


@dataclass(frozen=True)
class ForeignCurve:
    """Short-Weierstrass y² = x³ + a·x + b over a foreign prime field."""

    f: int  # foreign modulus
    a: int
    b: int

    def add(self, p1, p2):
        f = self.f
        (x1, y1), (x2, y2) = p1, p2
        assert x1 != x2, "affine add requires distinct x (planner bug)"
        lam = (y2 - y1) * pow(x2 - x1, -1, f) % f
        x3 = (lam * lam - x1 - x2) % f
        return x3, (lam * (x1 - x3) - y1) % f, lam

    def dbl(self, p1):
        f = self.f
        x1, y1 = p1
        assert y1 != 0, "affine double of a 2-torsion point (planner bug)"
        lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, f) % f
        x3 = (lam * lam - 2 * x1) % f
        return x3, (lam * (x1 - x3) - y1) % f, lam


class Layout:
    """One EC op per row. `limb_bits` is the range-table width: 16 for
    production domains (2^16-entry table), 8 for small test domains.
    `fbits` is the foreign-element width; f must satisfy 4·f ≥ 2^fbits
    (the non-canonical operand bound)."""

    def __init__(self, limb_bits: int = 16, fbits: int = 256):
        self.lb = limb_bits
        self.fbits = fbits
        self.nl = -(-fbits // limb_bits)  # limbs per foreign element
        # operands are range-checked to 2^fbits but may be NON-canonical
        # (≥ f), so positivity offsets go up to 48·f²: q gets nl+2
        # limbs and the carry chain 2·nl+1 positions
        self.nq = self.nl + 2
        self.npos = 2 * self.nl + 1
        i = 0

        def take(k):
            nonlocal i
            r = list(range(i, i + k))
            i += k
            return r

        self.sel_add = take(1)[0]
        self.sel_dbl = take(1)[0]
        nl = self.nl
        self.x1 = take(nl)
        self.y1 = take(nl)
        self.x2 = take(nl)
        self.y2 = take(nl)
        self.lam = take(nl)
        self.x3 = take(nl)
        self.y3 = take(nl)
        self.q = [take(self.nq) for _ in range(3)]
        self.carry = [take(self.npos) for _ in range(3)]
        # carry + 2^cb decomposed into nparts limbs for range checking
        import math

        self.cb = self.lb + math.ceil(math.log2(6 * self.nl)) + 2
        self.nparts = -(-(self.cb + 1) // self.lb)
        self.carry_dec = [
            [take(self.npos) for _ in range(self.nparts)] for _ in range(3)
        ]
        self.ncols = i

    def carry_bound_bits(self) -> int:
        """Carries satisfy |c| < 2^cb (per-position magnitude is at most
        ~6·nl limb products plus the propagated carry; 4x headroom)."""
        return self.cb


def to_limbs(v: int, L: Layout) -> list[int]:
    return [(v >> (L.lb * k)) & ((1 << L.lb) - 1) for k in range(L.nl)]


def plan_msm(curve: ForeignCurve, scalars: list[int], points: list):
    """Double-and-add schedule: ops list of ("add", point) / ("dbl",)
    computing Σ sᵢ·Pᵢ left-to-right over the joint bit-length, plus the
    start point. Fully determined by the public inputs — the verifier
    reruns it. Degenerate affine cases (equal x on add, 2-torsion
    double) abort; random inputs never hit them."""
    assert len(scalars) == len(points) and points
    nbits = max(s.bit_length() for s in scalars)
    assert nbits >= 1
    ops = []
    acc = None
    for bit in range(nbits - 1, -1, -1):
        if acc is not None:
            ops.append(("dbl", None))
        for s, pt in zip(scalars, points):
            if (s >> bit) & 1:
                if acc is None:
                    acc = ("start", pt)
                else:
                    ops.append(("add", pt))
    assert acc is not None, "zero MSM"
    return acc[1], ops


def execute(curve: ForeignCurve, start, ops):
    """Run the schedule, returning per-row records and the result."""
    acc = start
    rows = []
    for kind, pt in ops:
        if kind == "add":
            x3, y3, lam = curve.add(acc, pt)
            rows.append({"kind": "add", "p1": acc, "p2": pt,
                         "lam": lam, "out": (x3, y3)})
        else:
            x3, y3, lam = curve.dbl(acc)
            rows.append({"kind": "dbl", "p1": acc, "p2": (0, 0),
                         "lam": lam, "out": (x3, y3)})
        acc = (x3, y3)
    return rows, acc


def _check_terms(L: Layout, curve: ForeignCurve, kind: str, chk: int,
                 get, const):
    """Per-position integer terms of check `chk` (0..2) as a list
    indexed by limb position: LHS - q·f, which the carry chain forces
    to be 0. `get(name, limb)` reads an operand limb (int or Expr);
    `const(v)` lifts a host int. Shared by witness and constraint
    modes."""
    f = curve.f
    nl, lb = L.nl, L.lb
    fl = to_limbs(f, L)
    pos = [const(0) for _ in range(L.npos)]

    def addmul(aname, bname):  # Σ a_i·b_j at positions i+j
        for i in range(nl):
            ai = get(aname, i)
            for j in range(nl):
                pos[i + j] = pos[i + j] + ai * get(bname, j)

    def addlin(name, scale=1):  # + scale·operand
        for i in range(nl):
            pos[i] = pos[i] + const(scale) * get(name, i)

    def addconst(v):  # + integer constant, spread canonically
        k = 0
        while v:
            assert k < L.npos, "constant exceeds the carry chain"
            pos[k] = pos[k] + const(v & ((1 << lb) - 1))
            v >>= lb
            k += 1

    def addmul_shift(aname, bvals):  # Σ a_i·const(b_j)
        for i in range(nl):
            ai = get(aname, i)
            for j, bv in enumerate(bvals):
                if bv:
                    pos[i + j] = pos[i + j] + ai * const(bv)

    # offsets are multiples of f sized for NON-canonical operands
    # (< 2^256 ≤ 4f): x2-x1+4f > 0, 48f² > 3·(2^256)², 12f > 3·2^256
    f4 = to_limbs(4 * f, L) + [(4 * f) >> (lb * nl)]
    if chk == 0:
        if kind == "add":
            # λ·(x2 - x1 + 4f) + (y1 - y2 + 4f)
            addmul("lam", "x2")
            for i in range(nl):
                ai = get("lam", i)
                for j in range(nl):
                    pos[i + j] = pos[i + j] - ai * get("x1", j)
            addmul_shift("lam", f4)
            addlin("y1")
            addlin("y2", -1)
            addconst(4 * f)
        else:
            # λ·2y1 + 49f² - (3·x1² + a)
            addmul("lam", "y1")
            addmul("lam", "y1")
            for i in range(nl):
                ai = get("x1", i)
                for j in range(nl):
                    pos[i + j] = pos[i + j] - const(3) * ai * get("x1", j)
            addconst(49 * f * f - curve.a)
    elif chk == 1:
        # λ² + 12f - x1 - x2 - x3   (dbl: x2 ≡ x1)
        addmul("lam", "lam")
        addlin("x1", -1)
        addlin("x1" if kind == "dbl" else "x2", -1)
        addlin("x3", -1)
        addconst(12 * f)
    else:
        # λ·(x1 - x3 + 4f) + 8f - y1 - y3
        addmul("lam", "x1")
        for i in range(nl):
            ai = get("lam", i)
            for j in range(nl):
                pos[i + j] = pos[i + j] - ai * get("x3", j)
        addmul_shift("lam", f4)
        addlin("y1", -1)
        addlin("y3", -1)
        addconst(8 * f)
    # subtract q·f
    for i in range(L.nq):
        qi = get(f"q{chk}", i)
        for j, fv in enumerate(fl):
            if fv:
                pos[i + j] = pos[i + j] - qi * const(fv)
    return pos


def build_columns(f_native: FieldParams, curve: ForeignCurve, start, rows,
                  n: int, L: Layout) -> list[list[int]]:
    p = f_native.p
    assert len(rows) <= n
    cols = [[0] * n for _ in range(L.ncols)]
    cb = L.carry_bound_bits()
    for r, row in enumerate(rows):
        kind = row["kind"]
        cols[L.sel_add if kind == "add" else L.sel_dbl][r] = 1
        vals = {
            "x1": to_limbs(row["p1"][0], L), "y1": to_limbs(row["p1"][1], L),
            "x2": to_limbs(row["p2"][0], L), "y2": to_limbs(row["p2"][1], L),
            "lam": to_limbs(row["lam"], L),
            "x3": to_limbs(row["out"][0], L), "y3": to_limbs(row["out"][1], L),
        }
        for name, idxs in (("x1", L.x1), ("y1", L.y1), ("x2", L.x2),
                           ("y2", L.y2), ("lam", L.lam), ("x3", L.x3),
                           ("y3", L.y3)):
            for k, v in enumerate(vals[name]):
                cols[idxs[k]][r] = v
        for chk in range(3):
            # integer value of the check = q·f by construction: compute
            # the raw LHS first (q = 0), then the carry chain with q
            vals_q = dict(vals)
            vals_q[f"q{chk}"] = [0] * L.nq

            def get(name, i, vals_q=vals_q):
                return vals_q[name][i]

            pos = _check_terms(L, curve, kind, chk, get, lambda v: v)
            total = sum(v << (L.lb * k) for k, v in enumerate(pos))
            assert total % curve.f == 0, (kind, chk)
            q = total // curve.f
            assert 0 <= q < (1 << (L.lb * L.nq)), (kind, chk, q)
            qlimbs = [(q >> (L.lb * k)) & ((1 << L.lb) - 1)
                      for k in range(L.nq)]
            for k, v in enumerate(qlimbs):
                cols[L.q[chk][k]][r] = v
            vals_q[f"q{chk}"] = qlimbs
            pos = _check_terms(L, curve, kind, chk, get, lambda v: v)
            carry = 0
            for k in range(L.npos):
                v = pos[k] + carry
                assert v % (1 << L.lb) == 0, (kind, chk, k)
                carry = v >> L.lb
                assert abs(carry) < (1 << cb), (kind, chk, k, carry)
                cols[L.carry[chk][k]][r] = carry % p
                shifted = carry + (1 << cb)
                for part in range(L.nparts):
                    cols[L.carry_dec[chk][part][k]][r] = (
                        shifted >> (L.lb * part)) & ((1 << L.lb) - 1)
            assert carry == 0, (kind, chk)
    return cols


def make_logup(f_native: FieldParams, n: int, L: Layout) -> MultiLogup:
    from .o1vm.pickles import col

    def c(i):
        return E.Cell(col(i), E.CURR)

    one = E.Literal(1)
    specs: list[LookupSpec] = []
    # range checks: λ/x3/y3 limbs, q limbs, carry decomposition limbs.
    # (x1/y1 are chained copies of x3/y3 or pinned; x2/y2 are public.)
    for grp in (L.lam, L.x3, L.y3):
        for i in grp:
            specs.append(LookupSpec(TBL_RANGE, one, [c(i)]))
    cb = L.carry_bound_bits()
    # top decomposition part is < 2^(cb+1 - lb·(nparts-1)): shift it up
    # so the plain range table still bounds it exactly
    top_bits = cb + 1 - L.lb * (L.nparts - 1)
    assert 0 < top_bits <= L.lb
    top_shift = 1 << (L.lb - top_bits)
    for chk in range(3):
        for i in L.q[chk]:
            specs.append(LookupSpec(TBL_RANGE, one, [c(i)]))
        for part in range(L.nparts):
            shift = top_shift if part == L.nparts - 1 else 1
            for i in L.carry_dec[chk][part]:
                specs.append(LookupSpec(
                    TBL_RANGE, one,
                    [E.Literal(shift) * c(i) if shift > 1 else c(i)]))
    table = FixedTable(TBL_RANGE, f"range{L.lb}", [list(range(1 << L.lb))])
    return MultiLogup(f_native, specs, [table], n, L.ncols)


def constraints(f_native: FieldParams, curve: ForeignCurve, logup: MultiLogup,
                start, result, nrows: int, L: Layout,
                omega: int) -> list[E.Expr]:
    from .o1vm.pickles import col

    p = f_native.p
    n = logup.n

    def c(i, row=E.CURR):
        return E.Cell(col(i), row)

    one = E.Literal(1)
    sel_a, sel_d = c(L.sel_add), c(L.sel_dbl)
    sel_any = sel_a + sel_d
    out: list[E.Expr] = []
    out.append(sel_a.boolean())
    out.append(sel_d.boolean())
    out.append(sel_a * sel_d)

    names = {"x1": L.x1, "y1": L.y1, "x2": L.x2, "y2": L.y2,
             "lam": L.lam, "x3": L.x3, "y3": L.y3,
             "q0": L.q[0], "q1": L.q[1], "q2": L.q[2]}

    def get(name, i):
        return c(names[name][i])

    def const(v):
        return E.Literal(v % p)

    cb = L.carry_bound_bits()
    for kind, sel in (("add", sel_a), ("dbl", sel_d)):
        for chk in range(3):
            pos = _check_terms(L, curve, kind, chk, get, const)
            for k in range(L.npos):
                prev = c(L.carry[chk][k - 1]) if k else E.Literal(0)
                out.append(sel * (pos[k] + prev
                                  - E.Literal(1 << L.lb) * c(L.carry[chk][k])))
        # final carry must close the chain exactly
    for chk in range(3):
        out.append(sel_any * c(L.carry[chk][L.npos - 1]))
        # carry decomposition ties (range checks bound the pieces)
        for k in range(L.npos):
            dec: E.Expr = E.Literal(0)
            for part in range(L.nparts):
                dec = dec + E.Literal(1 << (L.lb * part)) * c(
                    L.carry_dec[chk][part][k])
            out.append(sel_any * (c(L.carry[chk][k]) + E.Literal(1 << cb)
                                  - dec))

    # accumulator chaining: next executing row's (x1,y1) = this (x3,y3)
    sel_next = c(L.sel_add, E.NEXT) + c(L.sel_dbl, E.NEXT)
    for i in range(L.nl):
        out.append(sel_any * sel_next * (c(L.x1[i], E.NEXT) - c(L.x3[i])))
        out.append(sel_any * sel_next * (c(L.y1[i], E.NEXT) - c(L.y3[i])))
    # contiguity: executing rows form a prefix (row 0 is executing);
    # the cyclic wraparound row n-1 is exempted via the normalized
    # last-row indicator (as in o1vm/mips.py)
    L0 = E.UnnormalizedLagrangeBasis(0)
    out.append(L0 * (sel_any - one))
    ell_last = E.UnnormalizedLagrangeBasis(n - 1) * E.Literal(
        pow(omega, n - 1, p) * pow(n, -1, p) % p
    )
    out.append((one - ell_last) * sel_next * (one - sel_any))

    # boundary pins: start accumulator and final result
    for i in range(L.nl):
        out.append(L0 * (c(L.x1[i]) - E.Literal(to_limbs(start[0], L)[i])))
        out.append(L0 * (c(L.y1[i]) - E.Literal(to_limbs(start[1], L)[i])))
    Lk = E.UnnormalizedLagrangeBasis(nrows - 1)
    for i in range(L.nl):
        out.append(Lk * (c(L.x3[i]) - E.Literal(to_limbs(result[0], L)[i])))
        out.append(Lk * (c(L.y3[i]) - E.Literal(to_limbs(result[1], L)[i])))

    out.extend(logup.constraints())
    return out


def _public_pin_columns(curve: ForeignCurve, start, ops, n: int, L: Layout):
    """The schedule columns the verifier pins by recommitment: the two
    selectors and the operand point (x2,y2) of every add row."""
    cols = {i: [0] * n
            for i in (L.sel_add, L.sel_dbl, *L.x2, *L.y2)}
    for r, (kind, pt) in enumerate(ops):
        cols[L.sel_add if kind == "add" else L.sel_dbl][r] = 1
        if kind == "add":
            for k, v in enumerate(to_limbs(pt[0], L)):
                cols[L.x2[k]][r] = v
            for k, v in enumerate(to_limbs(pt[1], L)):
                cols[L.y2[k]][r] = v
    return cols




def prove_msm(domain, srs, native_curve, fcurve: ForeignCurve,
              scalars: list[int], points: list, rng,
              L: Layout | None = None, device=None):
    """Prove MSM(scalars, points) over the foreign curve, on `device` (the
    card unless the caller passes device="cpu"), where `domain` and `srs`
    live too. Returns (proof, result_point)."""
    from .ops import limb
    from .o1vm.pickles import prove_columns

    dev = resolve_device(device)
    f = native_curve.scalar
    n = domain.d1.n
    L = L or Layout()
    start, ops = plan_msm(fcurve, scalars, points)
    rows, result = execute(fcurve, start, ops)
    cols = build_columns(f, fcurve, start, rows, n, L)
    logup = make_logup(f, n, L)
    full = logup.phase1_columns(cols)
    cons = constraints(f, fcurve, logup, start, result, len(rows), L,
                       domain.d1.group_gen)
    F = limb.device_field(f)
    packed = F.pack_mont([v for colv in full for v in colv], shape=(len(full), n), device=dev)
    proof = prove_columns(
        domain, srs, native_curve, packed, cons, rng,
        make_beta_columns=logup.make_phase2(F, dev), with_joint_combiner=True, device=dev,
    )
    return proof, result


def verify_msm(domain, srs, native_curve, fcurve: ForeignCurve,
               scalars: list[int], points: list, result, proof, rng,
               L: Layout | None = None, device=None) -> bool:
    """Check the proof against the public statement
    MSM(scalars, points) = result: rerun the planner, pin the range table
    and the schedule columns by recommitment, verify. On `device`, the
    SRS's (the card unless the caller passes device="cpu")."""
    from .o1vm.pickles import pinned_columns_match, verify_columns

    dev = resolve_device(device)
    if torch.device(srs.device).type != dev.type:
        raise ValueError(f"the SRS is on {srs.device}, expected {dev}")
    f = native_curve.scalar
    n = domain.d1.n
    L = L or Layout()
    start, ops = plan_msm(fcurve, scalars, points)
    if len(ops) > n:
        return False
    logup = make_logup(f, n, L)
    cons = constraints(f, fcurve, logup, start, result, len(ops), L,
                       domain.d1.group_gen)
    if not logup.verify_tables(domain, srs, proof):
        return False
    if not pinned_columns_match(domain, srs, proof,
                                _public_pin_columns(fcurve, start, ops, n, L), dev):
        return False
    return verify_columns(
        domain, srs, native_curve, cons, proof, rng,
        num_beta_columns=logup.num_phase2, with_joint_combiner=True,
    )
