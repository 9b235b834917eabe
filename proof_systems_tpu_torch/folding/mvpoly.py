"""Multivariate polynomials over a prime field (monomial representation).

Counterpart of proof_systems_tpu/folding/mvpoly.py, copied as it is: host
code over exact Python ints (the folding scheme's per-constraint
bookkeeping).

Capability mirror of mvpoly/src/lib.rs (the MVPoly trait) and
mvpoly/src/monomials.rs, used by the arrabbiata folding scheme to
compute Nova-style cross-terms of high-degree gate constraints
("Behind Nova: cross-terms computation for high degree gates").

Design: exponent-tuple -> coefficient dict over exact Python ints
(this is per-constraint setup/folding bookkeeping, not the data-parallel
hot path; the hot path — evaluating folded constraints over all rows —
goes through the expression framework's device walk in circuits/expr.py).
"""

from __future__ import annotations

from math import comb
from typing import Callable, Dict, Tuple

from ..circuits import expr as E

Exponents = Tuple[int, ...]


class MVPoly:
    """A polynomial in `nvars` variables of maximum (homogeneous) degree
    `max_degree` over F_p, stored as {exponent tuple: coefficient}."""

    __slots__ = ("p", "nvars", "max_degree", "terms")

    def __init__(self, p: int, nvars: int, max_degree: int, terms=None):
        self.p = p
        self.nvars = nvars
        self.max_degree = max_degree
        self.terms: Dict[Exponents, int] = {}
        if terms:
            for e, c in terms.items():
                self.add_monomial(e, c)

    # -- constructors ------------------------------------------------------

    @classmethod
    def constant(cls, p: int, nvars: int, max_degree: int, c: int) -> "MVPoly":
        return cls(p, nvars, max_degree, {(0,) * nvars: c % p})

    @classmethod
    def variable(cls, p: int, nvars: int, max_degree: int, i: int) -> "MVPoly":
        e = [0] * nvars
        e[i] = 1
        return cls(p, nvars, max_degree, {tuple(e): 1})

    @classmethod
    def random(cls, rng, p: int, nvars: int, max_degree: int) -> "MVPoly":
        """Dense random polynomial (testing only; mvpoly lib.rs:61)."""
        out = cls(p, nvars, max_degree)
        for e in _exponent_tuples(nvars, max_degree):
            out.terms[e] = rng.randrange(p)
        out._prune()
        return out

    @classmethod
    def from_expr(
        cls,
        expr: E.Expr,
        p: int,
        nvars: int,
        max_degree: int,
        column_index: Callable[[object], int],
        offset_next_row: int | None = None,
    ) -> "MVPoly":
        """Convert an expression-framework AST (mvpoly lib.rs:162 from_expr).

        Cells map to variables via `column_index`; a NEXT-row cell maps to
        `column_index(col) + offset_next_row` when given.
        """

        def walk(e: E.Expr) -> "MVPoly":
            if isinstance(e, E.Literal):
                return cls.constant(p, nvars, max_degree, e.value)
            if isinstance(e, E.Cell):
                i = column_index(e.col)
                if e.row == E.NEXT:
                    if offset_next_row is None:
                        raise ValueError("NEXT-row cell without offset_next_row")
                    i += offset_next_row
                return cls.variable(p, nvars, max_degree, i)
            if isinstance(e, E.Add):
                return walk(e.a) + walk(e.b)
            if isinstance(e, E.Sub):
                return walk(e.a) - walk(e.b)
            if isinstance(e, E.Mul):
                return walk(e.a) * walk(e.b)
            if isinstance(e, E.Pow):
                base = walk(e.a)
                out = cls.constant(p, nvars, max_degree, 1)
                for _ in range(e.n):
                    out = out * base
                return out
            raise ValueError(f"unsupported node for MVPoly: {type(e).__name__}")

        return walk(expr)

    # -- basic ops ---------------------------------------------------------

    def _prune(self) -> None:
        self.terms = {e: c for e, c in self.terms.items() if c}

    def add_monomial(self, exponents, coeff: int) -> None:
        e = tuple(exponents)
        assert len(e) == self.nvars and sum(e) <= self.max_degree
        c = (self.terms.get(e, 0) + coeff) % self.p
        if c:
            self.terms[e] = c
        else:
            self.terms.pop(e, None)

    def modify_monomial(self, exponents, coeff: int) -> None:
        e = tuple(exponents)
        assert len(e) == self.nvars
        if coeff % self.p:
            self.terms[e] = coeff % self.p
        else:
            self.terms.pop(e, None)

    def _like(self, terms) -> "MVPoly":
        out = MVPoly(self.p, self.nvars, self.max_degree)
        out.terms = {e: c for e, c in terms.items() if c}
        return out

    def __add__(self, o: "MVPoly") -> "MVPoly":
        t = dict(self.terms)
        for e, c in o.terms.items():
            t[e] = (t.get(e, 0) + c) % self.p
        return self._like(t)

    def __neg__(self) -> "MVPoly":
        return self._like({e: self.p - c for e, c in self.terms.items()})

    def __sub__(self, o: "MVPoly") -> "MVPoly":
        return self + (-o)

    def __mul__(self, o: "MVPoly") -> "MVPoly":
        t: Dict[Exponents, int] = {}
        for e1, c1 in self.terms.items():
            for e2, c2 in o.terms.items():
                e = tuple(a + b for a, b in zip(e1, e2))
                assert sum(e) <= self.max_degree, "product exceeds max degree"
                t[e] = (t.get(e, 0) + c1 * c2) % self.p
        return self._like(t)

    def mul_by_scalar(self, s: int) -> "MVPoly":
        return self._like({e: (c * s) % self.p for e, c in self.terms.items()})

    def double(self) -> "MVPoly":
        return self.mul_by_scalar(2)

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, MVPoly)
            and self.p == o.p
            and self.nvars == o.nvars
            and self.terms == o.terms
        )

    def __repr__(self) -> str:
        return f"MVPoly(nvars={self.nvars}, D={self.max_degree}, {len(self.terms)} terms)"

    # -- queries -----------------------------------------------------------

    def is_zero(self) -> bool:
        return not self.terms

    def is_constant(self) -> bool:
        return all(sum(e) == 0 for e in self.terms)

    def degree(self) -> int:
        return max((sum(e) for e in self.terms), default=0)

    def is_homogeneous(self) -> bool:
        return all(sum(e) == self.max_degree for e in self.terms)

    def is_multilinear(self) -> bool:
        return all(all(x <= 1 for x in e) for e in self.terms)

    # -- evaluation --------------------------------------------------------

    def eval(self, x) -> int:
        p = self.p
        acc = 0
        for e, c in self.terms.items():
            m = c
            for xi, ei in zip(x, e):
                if ei:
                    m = m * pow(xi, ei, p) % p
            acc += m
        return acc % p

    def homogeneous_eval(self, x, u: int) -> int:
        """Evaluate the degree-D homogenisation: each monomial of degree d
        is scaled by u^(D-d) (mvpoly lib.rs:230)."""
        p = self.p
        acc = 0
        for e, c in self.terms.items():
            m = c * pow(u, self.max_degree - sum(e), p) % p
            for xi, ei in zip(x, e):
                if ei:
                    m = m * pow(xi, ei, p) % p
            acc += m
        return acc % p

    # -- cross terms (Nova folding, high-degree gates) ---------------------

    def _r_expansion(self, eval1, eval2, u1: int, u2: int) -> list[int]:
        """Coefficients (in r) of P_hom(eval1 + r*eval2, u1 + r*u2):
        list of D+1 field elements; index k is the r^k coefficient."""
        p, D = self.p, self.max_degree
        out = [0] * (D + 1)
        for e, c in self.terms.items():
            # per-monomial polynomial in r: product of binomial expansions
            poly = [c % p]
            degs = list(e) + [D - sum(e)]
            vals1 = [a % p for a in eval1] + [u1 % p]
            vals2 = [a % p for a in eval2] + [u2 % p]
            for a1, a2, d in zip(vals1, vals2, degs):
                if d == 0:
                    continue
                base = [
                    comb(d, j) * pow(a1, d - j, p) * pow(a2, j, p) % p
                    for j in range(d + 1)
                ]
                nxt = [0] * (len(poly) + d)
                for i, ci in enumerate(poly):
                    if not ci:
                        continue
                    for j, bj in enumerate(base):
                        nxt[i + j] = (nxt[i + j] + ci * bj) % p
                poly = nxt
            for k, ck in enumerate(poly):
                out[k] = (out[k] + ck) % p
        return out

    def compute_cross_terms(self, eval1, eval2, u1: int, u2: int) -> Dict[int, int]:
        """Cross-terms {k: coeff of r^k} for k = 1..D-1 (lib.rs:240).

        P_hom(e1 + r e2, u1 + r u2)
          = P_hom(e1,u1) + sum_k r^k ct_k + r^D P_hom(e2,u2).
        """
        exp = self._r_expansion(eval1, eval2, u1, u2)
        return {k: exp[k] for k in range(1, self.max_degree)}

    def compute_cross_terms_scaled(
        self, eval1, eval2, u1: int, u2: int, scalar1: int, scalar2: int
    ) -> Dict[int, int]:
        """Cross-terms of Q = alpha * P with alpha treated as one more
        variable (homogeneous degree D+1): k = 1..D (lib.rs:260)."""
        p, D = self.p, self.max_degree
        exp = self._r_expansion(eval1, eval2, u1, u2)
        scaled = [0] * (D + 2)
        for k, ck in enumerate(exp):
            scaled[k] = (scaled[k] + ck * scalar1) % p
            scaled[k + 1] = (scaled[k + 1] + ck * scalar2) % p
        return {k: scaled[k] for k in range(1, D + 1)}


def compute_combined_cross_terms(
    polys: list[MVPoly],
    eval1,
    eval2,
    u1: int,
    u2: int,
    combiner1: int,
    combiner2: int,
) -> Dict[int, int]:
    """Cross-terms of sum_i combiner^i * P_i (mvpoly lib.rs:306), with the
    combiner alpha itself a folded variable (alpha1/alpha2 powers)."""
    assert combiner1 and combiner2 and u1 and u2
    p = polys[0].p if polys else 0
    acc: Dict[int, int] = {}
    for i, poly in enumerate(polys):
        s1 = pow(combiner1, i, p)
        s2 = pow(combiner2, i, p)
        res = poly.compute_cross_terms_scaled(eval1, eval2, u1, u2, s1, s2)
        for k, v in res.items():
            acc[k] = (acc.get(k, 0) + v) % p
    return acc


def _exponent_tuples(nvars: int, max_degree: int):
    """All exponent tuples with total degree <= max_degree."""
    if nvars == 0:
        yield ()
        return
    for first in range(max_degree + 1):
        for rest in _exponent_tuples(nvars - 1, max_degree - first):
            yield (first, *rest)


def cross_terms_alpha_vec(
    polys: list[MVPoly],
    eval1,
    eval2,
    u1: int,
    u2: int,
    alphas1: list[int],
    alphas2: list[int],
) -> Dict[int, int]:
    """Cross-terms of sum_i alpha_i * P_i where each alpha_i is its own
    folded variable with instance values (alphas1[i], alphas2[i]).

    Generalizes compute_combined_cross_terms to accumulators whose
    combiner vector is no longer a geometric sequence (after >= 1 fold).
    Returns {k: coeff} for k = 1..D+1 where D = max_degree.
    """
    p = polys[0].p if polys else 0
    acc: Dict[int, int] = {}
    for poly, a1, a2 in zip(polys, alphas1, alphas2):
        res = poly.compute_cross_terms_scaled(eval1, eval2, u1, u2, a1, a2)
        for k, v in res.items():
            acc[k] = (acc.get(k, 0) + v) % p
    return acc


def to_expr(poly: MVPoly, var_expr: Callable[[int], E.Expr], u: int | None = None) -> E.Expr:
    """Convert back to an expression-framework AST. `var_expr(i)` supplies
    the Expr for variable i. If `u` is given, each monomial is scaled by
    u^(D - deg) (i.e. the degree-D homogenisation evaluated at literal u)."""
    out: E.Expr | None = None
    p, D = poly.p, poly.max_degree
    for e, c in sorted(poly.terms.items()):
        if u is not None:
            c = c * pow(u, D - sum(e), p) % p
        term: E.Expr = E.Literal(c)
        for i, ei in enumerate(e):
            for _ in range(ei):
                term = term * var_expr(i)
        out = term if out is None else out + term
    return out if out is not None else E.Literal(0)


# ---------------------------------------------------------------------------
# Prime (dense) representation — mvpoly/src/prime.rs.
#
# Each variable X_i is assigned a distinct prime q_i; the monomial
# prod X_i^{e_i} is identified by the integer prod q_i^{e_i}. A
# polynomial of N variables and max degree D is a dense coefficient
# vector over the sorted list of "normalized indices" (prime.rs:523
# compute_normalized_indices): all such products <= q_N^D that factor
# entirely over {q_1..q_N} with total multiplicity <= D. Multiplication
# of monomials is integer multiplication of indices.
# ---------------------------------------------------------------------------


def _first_primes(n: int) -> list[int]:
    primes: list[int] = []
    c = 2
    while len(primes) < n:
        if all(c % q for q in primes):
            primes.append(c)
        c += 1
    return primes


def _normalized_indices(nvars: int, max_degree: int) -> list[int]:
    primes = _first_primes(nvars)
    vals = {1}
    for _ in range(max_degree):
        vals |= {v * q for v in vals for q in primes}
    return sorted(vals)


class PrimeMVPoly:
    """Dense prime-indexed representation (mvpoly/src/prime.rs).

    Same algebra as MVPoly; coefficient vector `coeffs` is aligned with
    `self.indices` = compute_normalized_indices(N, D)."""

    __slots__ = ("p", "nvars", "max_degree", "primes", "indices", "pos", "coeffs")

    def __init__(self, p: int, nvars: int, max_degree: int, coeffs=None):
        self.p = p
        self.nvars = nvars
        self.max_degree = max_degree
        self.primes = _first_primes(nvars)
        self.indices = _normalized_indices(nvars, max_degree)
        self.pos = {v: i for i, v in enumerate(self.indices)}
        self.coeffs = list(coeffs) if coeffs is not None else [0] * len(self.indices)
        assert len(self.coeffs) == len(self.indices)

    # -- conversions ---------------------------------------------------

    def _exp_of_index(self, value: int) -> Exponents:
        e = []
        for q in self.primes:
            k = 0
            while value % q == 0:
                value //= q
                k += 1
            e.append(k)
        assert value == 1
        return tuple(e)

    def _index_of_exp(self, e: Exponents) -> int:
        v = 1
        for q, ei in zip(self.primes, e):
            v *= q**ei
        return v

    def to_monomials(self) -> MVPoly:
        out = MVPoly(self.p, self.nvars, self.max_degree)
        for v, c in zip(self.indices, self.coeffs):
            if c:
                out.terms[self._exp_of_index(v)] = c
        return out

    @classmethod
    def from_monomials(cls, m: MVPoly) -> "PrimeMVPoly":
        out = cls(m.p, m.nvars, m.max_degree)
        for e, c in m.terms.items():
            out.coeffs[out.pos[out._index_of_exp(e)]] = c % m.p
        return out

    @classmethod
    def constant(cls, p: int, nvars: int, max_degree: int, c: int) -> "PrimeMVPoly":
        out = cls(p, nvars, max_degree)
        out.coeffs[out.pos[1]] = c % p
        return out

    @classmethod
    def variable(cls, p: int, nvars: int, max_degree: int, i: int) -> "PrimeMVPoly":
        out = cls(p, nvars, max_degree)
        out.coeffs[out.pos[out.primes[i]]] = 1
        return out

    @classmethod
    def random(cls, rng, p: int, nvars: int, max_degree: int) -> "PrimeMVPoly":
        out = cls(p, nvars, max_degree)
        out.coeffs = [rng.randrange(p) for _ in out.indices]
        return out

    # -- algebra (prime.rs Add/Mul/Neg/Sub impls) -----------------------

    def _like(self, coeffs) -> "PrimeMVPoly":
        return PrimeMVPoly(self.p, self.nvars, self.max_degree, coeffs)

    def _check_like(self, o: "PrimeMVPoly") -> None:
        assert (self.nvars, self.max_degree) == (o.nvars, o.max_degree), (
            "mixed-arity/degree prime polys (the reference encodes N, D in "
            "the type, prime.rs Dense<F, N, D>)"
        )

    def __add__(self, o: "PrimeMVPoly") -> "PrimeMVPoly":
        self._check_like(o)
        return self._like([(a + b) % self.p for a, b in zip(self.coeffs, o.coeffs)])

    def __neg__(self) -> "PrimeMVPoly":
        return self._like([(-a) % self.p for a in self.coeffs])

    def __sub__(self, o: "PrimeMVPoly") -> "PrimeMVPoly":
        self._check_like(o)
        return self._like([(a - b) % self.p for a, b in zip(self.coeffs, o.coeffs)])

    def __mul__(self, o: "PrimeMVPoly") -> "PrimeMVPoly":
        # degree overflow must stay representable, as in prime.rs (the
        # caller guarantees deg(self) + deg(o) <= D via types there)
        out = [0] * len(self.indices)
        nz1 = [(v, c) for v, c in zip(self.indices, self.coeffs) if c]
        nz2 = [(v, c) for v, c in zip(o.indices, o.coeffs) if c]
        for v1, c1 in nz1:
            for v2, c2 in nz2:
                pos = self.pos.get(v1 * v2)
                assert pos is not None, "product degree exceeds max_degree"
                out[pos] = (out[pos] + c1 * c2) % self.p
        return self._like(out)

    def mul_by_scalar(self, s: int) -> "PrimeMVPoly":
        return self._like([a * s % self.p for a in self.coeffs])

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, PrimeMVPoly)
            and self.p == o.p
            and self.nvars == o.nvars
            and self.max_degree == o.max_degree
            and self.coeffs == o.coeffs
        )

    def is_zero(self) -> bool:
        return all(c == 0 for c in self.coeffs)

    def is_constant(self) -> bool:
        return all(c == 0 for v, c in zip(self.indices, self.coeffs) if v != 1)

    def degree(self) -> int:
        return max(
            (sum(self._exp_of_index(v)) for v, c in zip(self.indices, self.coeffs) if c),
            default=0,
        )

    def is_homogeneous(self) -> bool:
        degs = {sum(self._exp_of_index(v)) for v, c in zip(self.indices, self.coeffs) if c}
        return degs <= {self.max_degree}

    def is_multilinear(self) -> bool:
        return all(
            max(self._exp_of_index(v), default=0) <= 1
            for v, c in zip(self.indices, self.coeffs)
            if c
        )

    # -- evaluation ------------------------------------------------------

    def eval(self, x) -> int:
        acc = 0
        for v, c in zip(self.indices, self.coeffs):
            if not c:
                continue
            t = c
            for xi, ei in zip(x, self._exp_of_index(v)):
                if ei:
                    t = t * pow(xi, ei, self.p) % self.p
            acc = (acc + t) % self.p
        return acc

    def homogeneous_eval(self, x, u: int) -> int:
        acc = 0
        D = self.max_degree
        for v, c in zip(self.indices, self.coeffs):
            if not c:
                continue
            e = self._exp_of_index(v)
            t = c * pow(u, D - sum(e), self.p) % self.p
            for xi, ei in zip(x, e):
                if ei:
                    t = t * pow(xi, ei, self.p) % self.p
            acc = (acc + t) % self.p
        return acc

    def compute_cross_terms(self, eval1, eval2, u1: int, u2: int) -> Dict[int, int]:
        return self.to_monomials().compute_cross_terms(eval1, eval2, u1, u2)

    def compute_cross_terms_scaled(
        self, eval1, eval2, u1: int, u2: int, s1: int, s2: int
    ) -> Dict[int, int]:
        return self.to_monomials().compute_cross_terms_scaled(eval1, eval2, u1, u2, s1, s2)
