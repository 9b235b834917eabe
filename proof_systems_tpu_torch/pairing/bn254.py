"""BN254 (alt_bn128) optimal-ate pairing, pure host integers.

The KZG backend (poly_commitment/kzg.py) mirrors the reference's
pairing-based PCS (poly-commitment/src/kzg.rs:94-505), which targets
BN254 for EVM compatibility. The reference gets its pairing from
arkworks (`ark-bn254`); here it is implemented from the curve spec:

  - Fq:  p = 36x^4 + 36x^3 + 24x^2 + 6x + 1, x = 4965661367192848881
  - Fr:  r = 36x^4 + 36x^3 + 18x^2 + 6x + 1
  - G1:  E/Fq: y^2 = x^3 + 3, generator (1, 2)
  - G2:  E'/Fq2: y^2 = x^3 + 3/(9+u), a D-type sextic twist
  - towers: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi), xi = 9+u,
    Fq12 = Fq6[w]/(w^2 - v)    (so w^6 = xi)
  - untwist psi(x', y') = (x' w^2, y' w^3) maps E' onto E over Fq12
  - optimal ate: Miller loop over 6x+2, two Frobenius line steps,
    final exponentiation (p^12-1)/r via the standard BN chain.

Everything is host-side: pairings run once per KZG verification, far
off the prover's device hot path (the reference likewise keeps KZG
out of its IPA hot path). Field elements are ints; Fq2/Fq6/Fq12 are
nested tuples, kept allocation-light for the ~1.6k Fq12 mults a
pairing costs.

Self-checks in tests/test_pairing.py: subgroup orders, bilinearity
e(aP, bQ) = e(P, Q)^(ab), hard-part chain vs the literal exponent
(p^4 - p^2 + 1)/r, and KZG end-to-end.
"""

from __future__ import annotations

# -- parameters ------------------------------------------------------------

X = 4965661367192848881  # BN parameter
FQ = 36 * X**4 + 36 * X**3 + 24 * X**2 + 6 * X + 1  # base field modulus
FR = 36 * X**4 + 36 * X**3 + 18 * X**2 + 6 * X + 1  # scalar field modulus
ATE_LOOP = 6 * X + 2

B1 = 3  # G1: y^2 = x^3 + 3

G1 = (1, 2)

# generator of the r-torsion subgroup of the twist (standard, e.g. EIP-197)
G2 = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

p = FQ  # local alias

# -- Fq2 = Fq[u]/(u^2 + 1) --------------------------------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)


def f2_sub(a, b):
    return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)


def f2_neg(a):
    return (-a[0] % p, -a[1] % p)


def f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    t2 = (a0 + a1) * (b0 + b1)
    return ((t0 - t1) % p, (t2 - t0 - t1) % p)


def f2_sq(a):
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a0 + a1) * (a0 - a1) % p, 2 * a0 * a1 % p)


def f2_conj(a):
    return (a[0], -a[1] % p)


def f2_muli(a, k: int):
    return (a[0] * k % p, a[1] * k % p)


def f2_inv(a):
    a0, a1 = a
    d = pow(a0 * a0 + a1 * a1, p - 2, p)
    return (a0 * d % p, -a1 * d % p)


def f2_pow(a, e: int):
    r = (1, 0)
    while e:
        if e & 1:
            r = f2_mul(r, a)
        a = f2_sq(a)
        e >>= 1
    return r


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # v^3 = xi

# -- Fq6 = Fq2[v]/(v^3 - xi) -------------------------------------------------


def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def _mul_xi(a):
    # (a0 + a1 u)(9 + u) = 9a0 - a1 + (a0 + 9a1) u
    a0, a1 = a
    return ((9 * a0 - a1) % p, (a0 + 9 * a1) % p)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), _mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sq(a):
    return f6_mul(a, a)


def f6_mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2
    return (_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sq(a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_sq(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sq(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a2, _mul_xi(c1)), f2_add(f2_mul(a1, _mul_xi(c2)), f2_mul(a0, c0)))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)

# -- Fq12 = Fq6[w]/(w^2 - v) --------------------------------------------------


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (f6_add(t0, f6_mul_by_v(t1)), c1)


def f12_sq(a):
    a0, a1 = a
    t = f6_mul(a0, a1)
    c0 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_by_v(a1))), f6_add(t, f6_mul_by_v(t)))
    return (c0, f6_add(t, t))


def f12_conj(a):
    """a^(p^6): w -> -w."""
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    t = f6_inv(f6_sub(f6_sq(a0), f6_mul_by_v(f6_sq(a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_pow(a, e: int):
    r = F12_ONE
    while e:
        if e & 1:
            r = f12_mul(r, a)
        a = f12_sq(a)
        e >>= 1
    return r


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)

# -- Frobenius ----------------------------------------------------------------
# v^p = g1 * v with g1 = xi^((p-1)/3);  w^p = g w with g = xi^((p-1)/6);
# both in Fq2 since p = 1 mod 6.

_G16 = f2_pow(XI, (p - 1) // 6)  # xi^((p-1)/6)
_G13 = f2_sq(_G16)  # xi^((p-1)/3)
_G12 = f2_mul(_G13, _G16)  # xi^((p-1)/2)


def f6_frob(a):
    """a^p on Fq6 (coefficients conjugated, v-powers twisted)."""
    return (
        f2_conj(a[0]),
        f2_mul(f2_conj(a[1]), _G13),
        f2_mul(f2_conj(a[2]), f2_sq(_G13)),
    )


def f12_frob(a):
    """a^p on Fq12."""
    b0 = f6_frob(a[0])
    b1 = f6_frob(a[1])
    # multiply the w-part coefficientwise by g16 (scalar in Fq2)
    b1 = (f2_mul(b1[0], _G16), f2_mul(b1[1], _G16), f2_mul(b1[2], _G16))
    return (b0, b1)


def f12_frob_n(a, n: int):
    for _ in range(n):
        a = f12_frob(a)
    return a


# -- G1 (affine, None = infinity) ---------------------------------------------


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B1) % p == 0


def g1_neg(pt):
    return None if pt is None else (pt[0], -pt[1] % p)


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, p - 2, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def g1_mul(k: int, pt):
    k %= FR
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, pt)
        pt = g1_add(pt, pt)
        k >>= 1
    return acc


# -- G2 on the twist (affine over Fq2, None = infinity) ------------------------

B2 = f2_mul((3, 0), f2_inv(XI))  # 3/(9+u)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), B2)) == F2_ZERO


def g2_neg(pt):
    return None if pt is None else (pt[0], f2_neg(pt[1]))


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_muli(f2_sq(x1), 3), f2_inv(f2_muli(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sq(lam), f2_add(x1, x2))
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_mul(k: int, pt):
    k %= FR
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, pt)
        pt = g2_add(pt, pt)
        k >>= 1
    return acc


# -- Miller loop over untwisted coordinates ------------------------------------
# psi(x', y') = (x' w^2, y' w^3): coordinates are Fq12 elements of sparse
# form; represent generally (clarity over micro-optimization).


def _fq12_from_fq(c: int):
    return (((c % p, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def _untwist(pt):
    """Map a twist point to E(Fq12)."""
    x, y = pt
    # x * w^2: w^2 = v  -> Fq6 coeff slot 1 of the w^0 part
    xw2 = ((F2_ZERO, x, F2_ZERO), F6_ZERO)
    # y * w^3 = y * v * w -> Fq6 coeff slot 1 of the w^1 part
    yw3 = (F6_ZERO, (F2_ZERO, y, F2_ZERO))
    return (xw2, yw3)


def _e12_add(a, b):
    """Affine add on E(Fq12) returning (point, lambda_used) — helper for
    line evaluation; a != -b assumed (the Miller loop never hits it for
    r-torsion inputs)."""
    (x1, y1), (x2, y2) = a, b
    if x1 == x2 and y1 == y2:
        lam = f12_mul(
            f12_mul(f12_sq(x1), _fq12_from_fq(3)),
            f12_inv(f12_mul(y1, _fq12_from_fq(2))),
        )
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sq(lam), f12_add(x1, x2))
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    return (x3, y3), lam


def _line(T, Q, P, lam):
    """Evaluate the line through T (slope lam, both on E(Fq12)) at the
    G1 point P: y_P - y_T - lam (x_P - x_T)."""
    xT, yT = T
    xP, yP = P
    return f12_sub(f12_sub(yP, yT), f12_mul(lam, f12_sub(xP, xT)))


def miller_loop(Q, P):
    """Optimal-ate Miller loop f_{6x+2,Q}(P) * frobenius line steps.

    Q: twist point (Fq2 affine), P: G1 point (Fq affine). Returns an
    Fq12 element (un-exponentiated)."""
    if Q is None or P is None:
        return F12_ONE
    Pq = (_fq12_from_fq(P[0]), _fq12_from_fq(P[1]))
    Qu = _untwist(Q)
    T = Qu
    f = F12_ONE
    for bit in bin(ATE_LOOP)[3:]:
        T2, lam = _e12_add(T, T)
        f = f12_mul(f12_sq(f), _line(T, T, Pq, lam))
        T = T2
        if bit == "1":
            TQ, lam = _e12_add(T, Qu)
            f = f12_mul(f, _line(T, Qu, Pq, lam))
            T = TQ
    # Frobenius steps: Q1 = pi(Q), Q2 = pi^2(Q); add Q1, subtract Q2.
    Q1 = (f12_frob(Qu[0]), f12_frob(Qu[1]))
    Q2 = (f12_frob(Q1[0]), f12_frob(Q1[1]))
    nQ2 = (Q2[0], f12_sub(F12_ZERO, Q2[1]))
    TQ, lam = _e12_add(T, Q1)
    f = f12_mul(f, _line(T, Q1, Pq, lam))
    T = TQ
    _, lam = _e12_add(T, nQ2)
    f = f12_mul(f, _line(T, nQ2, Pq, lam))
    return f


# -- final exponentiation -------------------------------------------------------


_HARD_EXP = (p**4 - p**2 + 1) // FR


def final_exponentiation(f):
    """f^((p^12 - 1)/r).

    Easy part via conjugation/frobenius; hard part (p^4 - p^2 + 1)/r by
    the literal ~3046-bit exponent (a few thousand Fq12 ops, well under
    a second on host — KZG verification is off the device hot path, so
    clarity beats the Devegili-Scott-Dahab chain here)."""
    f = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6 - 1)
    f = f12_mul(f12_frob_n(f, 2), f)  # ^(p^2 + 1)
    return f12_pow(f, _HARD_EXP)


def pairing(P, Q):
    """e(P, Q) with P in G1, Q in G2 (twist coords). Returns Fq12."""
    return final_exponentiation(miller_loop(Q, P))


def multi_pairing(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — one shared final exponentiation."""
    f = F12_ONE
    for P, Q in pairs:
        if P is None or Q is None:
            continue
        f = f12_mul(f, miller_loop(Q, P))
    return final_exponentiation(f) == F12_ONE
