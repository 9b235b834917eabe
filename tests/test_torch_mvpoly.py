"""The port's multivariate polynomials (folding/mvpoly.py) against the JAX
package's, at the inputs of tests/test_mvpoly.py: each scenario runs once
with each package's module on the same seeded random.Random draws and the
results (coefficient dicts, evaluations, cross terms, prime-indexed
coefficient vectors, predicates) are compared exactly; the identities that
tests/test_mvpoly.py checks hold for the port's results too."""

import random

import pytest

from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.folding import mvpoly as jmv
from proof_systems_tpu_torch.circuits import expr as E
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.folding import mvpoly as mv

P = Fp.p
MODULES = ((mv, E), (jmv, JE))
FIELD = {E: Fp, JE: JFp}


def rand_point(rng, n):
    return [rng.randrange(1, P) for _ in range(n)]


def ring_ops(m, ex):
    rng = random.Random(1)
    n, d = 3, 2
    a = m.MVPoly.random(rng, P, n, 2 * d)
    b = m.MVPoly.random(rng, P, n, 2 * d)
    a.terms = {e: c for e, c in a.terms.items() if sum(e) <= d}
    b.terms = {e: c for e, c in b.terms.items() if sum(e) <= d}
    x = rand_point(rng, n)
    polys = [a + b, a - b, a * b, -a, a.mul_by_scalar(7), a.double()]
    assert (a * b).eval(x) == a.eval(x) * b.eval(x) % P
    return [q.terms for q in polys] + [[q.eval(x) for q in polys]]


def degree_and_flags(m, ex):
    p = m.MVPoly(P, 2, 4)
    p.add_monomial((1, 1), 3)
    p.add_monomial((0, 0), 5)
    p.modify_monomial((2, 0), 11)
    q = m.MVPoly(P, 2, 2, {(2, 0): 1, (1, 1): 4})
    c = m.MVPoly.constant(P, 2, 2, 9)
    v = m.MVPoly.variable(P, 2, 2, 1)
    return [(t.terms, t.degree(), t.is_homogeneous(), t.is_multilinear(), t.is_constant(),
             t.is_zero()) for t in (p, q, c, v)]


def homogeneous_eval(m, ex):
    rng = random.Random(2)
    poly = m.MVPoly.random(rng, P, 3, 4)
    x = rand_point(rng, 3)
    u = rng.randrange(1, P)
    return poly.terms, poly.homogeneous_eval(x, u), poly.homogeneous_eval(x, 1), poly.eval(x)


def cross_terms(m, ex):
    rng = random.Random(3)
    n, d = 4, 3
    poly = m.MVPoly.random(rng, P, n, d)
    e1, e2 = rand_point(rng, n), rand_point(rng, n)
    u1, u2 = rng.randrange(1, P), rng.randrange(1, P)
    cts = poly.compute_cross_terms(e1, e2, u1, u2)
    r = rng.randrange(1, P)
    lhs = poly.homogeneous_eval([(a + r * b) % P for a, b in zip(e1, e2)], (u1 + r * u2) % P)
    rhs = poly.homogeneous_eval(e1, u1) + sum(c * pow(r, k, P) for k, c in cts.items())
    assert lhs == (rhs + poly.homogeneous_eval(e2, u2) * pow(r, d, P)) % P
    return cts


def cross_terms_scaled(m, ex):
    rng = random.Random(4)
    poly = m.MVPoly.random(rng, P, 3, 3)
    e1, e2 = rand_point(rng, 3), rand_point(rng, 3)
    u1, u2 = rng.randrange(1, P), rng.randrange(1, P)
    s1, s2 = rng.randrange(1, P), rng.randrange(1, P)
    return poly.compute_cross_terms_scaled(e1, e2, u1, u2, s1, s2)


def combined_cross_terms(m, ex):
    rng = random.Random(5)
    polys = [m.MVPoly.random(rng, P, 3, 2) for _ in range(4)]
    e1, e2 = rand_point(rng, 3), rand_point(rng, 3)
    u1, u2 = rng.randrange(1, P), rng.randrange(1, P)
    c1, c2 = rng.randrange(1, P), rng.randrange(1, P)
    alphas1 = [rng.randrange(1, P) for _ in polys]
    alphas2 = [rng.randrange(1, P) for _ in polys]
    return (m.compute_combined_cross_terms(polys, e1, e2, u1, u2, c1, c2),
            m.cross_terms_alpha_vec(polys, e1, e2, u1, u2, alphas1, alphas2))


def from_expr(m, ex):
    x0, x1 = ex.Cell(0, ex.CURR), ex.Cell(1, ex.CURR)
    ast = (x0 + ex.Literal(2)) * (x1 - x0) + x1 * x1
    poly = m.MVPoly.from_expr(ast, P, 2, 2, lambda c: c)
    nxt = m.MVPoly.from_expr(ex.Cell(0, ex.CURR) * ex.Cell(1, ex.NEXT), P, 4, 2, lambda c: c,
                             offset_next_row=2)
    rng = random.Random(6)
    return poly.terms, nxt.terms, [poly.eval([rng.randrange(P), rng.randrange(P)])
                                   for _ in range(4)]


def to_expr(m, ex):
    rng = random.Random(7)
    poly = m.MVPoly.random(rng, P, 3, 3)
    u = rng.randrange(1, P)
    x = rand_point(rng, 3)
    out = []
    for uu in (None, u):
        e = m.to_expr(poly, lambda i: ex.Literal(x[i]), u=uu)
        ctx = ex.HostEvalContext(f=FIELD[ex], get_cell=None, challenges={}, endo=0, mds=[],
                                 point=0, domain_n=1, omega=1, zk_rows=0)
        out.append(ex.eval_host(e, ctx) % P)
    assert out == [poly.eval(x), poly.homogeneous_eval(x, u)]
    return out


def prime_indices(m, ex):
    return [m._normalized_indices(n, d) for n, d in [(2, 2), (3, 3), (4, 2)]]


def prime_algebra(m, ex):
    rng = random.Random(11)
    out = []
    for _ in range(8):
        a, b = (m.PrimeMVPoly.random(rng, P, 3, 3) for _ in range(2))
        x = [rng.randrange(P) for _ in range(3)]
        s = rng.randrange(P)
        out.append(((a + b).coeffs, (a - b).coeffs, (-a).coeffs, a.mul_by_scalar(s).coeffs,
                    (a + b).eval(x), a.homogeneous_eval(x, s or 1)))
    return out


def prime_mul(m, ex):
    rng = random.Random(12)
    out = []
    for _ in range(8):
        a, b = m.PrimeMVPoly(P, 3, 4), m.PrimeMVPoly(P, 3, 4)
        for poly in (a, b):
            for v in poly.indices:
                if sum(poly._exp_of_index(v)) <= 2:
                    poly.coeffs[poly.pos[v]] = rng.randrange(P)
        x = [rng.randrange(P) for _ in range(3)]
        prod = a * b
        assert prod.eval(x) == a.eval(x) * b.eval(x) % P
        out.append((prod.coeffs, prod.degree()))
    return out


def prime_roundtrip(m, ex):
    rng = random.Random(13)
    out = []
    for _ in range(6):
        mono = m.MVPoly.random(rng, P, 3, 3)
        pr = m.PrimeMVPoly.from_monomials(mono)
        assert pr.to_monomials() == mono
        x = [rng.randrange(P) for _ in range(3)]
        u = rng.randrange(1, P)
        out.append((pr.coeffs, pr.eval(x), pr.homogeneous_eval(x, u), pr.degree(),
                    pr.is_homogeneous(), pr.is_multilinear(), pr.is_constant()))
    return out


def prime_cross_terms(m, ex):
    rng = random.Random(14)
    mono = m.MVPoly.random(rng, P, 3, 3)
    pr = m.PrimeMVPoly.from_monomials(mono)
    e1 = [rng.randrange(P) for _ in range(3)]
    e2 = [rng.randrange(P) for _ in range(3)]
    u1, u2 = rng.randrange(1, P), rng.randrange(1, P)
    ct = pr.compute_cross_terms(e1, e2, u1, u2)
    assert ct == mono.compute_cross_terms(e1, e2, u1, u2)
    return ct, pr.compute_cross_terms_scaled(e1, e2, u1, u2, 3, 5)


SCENARIOS = [ring_ops, degree_and_flags, homogeneous_eval, cross_terms, cross_terms_scaled,
             combined_cross_terms, from_expr, to_expr, prime_indices, prime_algebra, prime_mul,
             prime_roundtrip, prime_cross_terms]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_equals_jax(scenario):
    got, want = (scenario(m, ex) for m, ex in MODULES)
    assert got == want


def test_degree_overflow_raises_in_both():
    for m, _ in MODULES:
        a = m.MVPoly.variable(P, 2, 1, 0)
        with pytest.raises(AssertionError, match="max degree"):
            a * a
        b = m.PrimeMVPoly.variable(P, 2, 1, 0)
        with pytest.raises(AssertionError, match="max_degree"):
            b * b


def test_from_expr_of_a_pow_node_fails_in_both():
    """A fault of the JAX package, copied for parity: MVPoly.from_expr reads
    a Pow node's exponent as `.n`, but the node keeps it in `.e`. No
    constraint of the folding scheme has a Pow node (the IVC writes x^5 as
    products)."""
    for m, ex in MODULES:
        with pytest.raises(AttributeError, match="'Pow' object has no attribute 'n'"):
            m.MVPoly.from_expr(ex.Pow(ex.Cell(0, ex.CURR), 2), P, 1, 2, lambda c: c)
