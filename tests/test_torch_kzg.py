"""The port's BN254 pairing and KZG commitment (pairing/bn254.py,
poly_commitment/kzg.py) against the JAX package's on tests/test_kzg.py's
statements, with the same seeds: pairing values, trusted setups,
commitments, openings and verifications. Python integers on the host on
both sides, so every comparison is exact."""

import random

from proof_systems_tpu.pairing import bn254 as jbn
from proof_systems_tpu.poly_commitment import kzg as jkzg
from proof_systems_tpu_torch.pairing import bn254 as bn
from proof_systems_tpu_torch.poly_commitment import kzg


class Rng:
    def __init__(self, seed):
        self.r = random.Random(seed)

    def field(self, p):
        return self.r.randrange(p)


def _poly_eval(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % bn.FR
    return acc


def test_constants_and_generators():
    assert (bn.FQ, bn.FR, bn.G1, bn.G2) == (jbn.FQ, jbn.FR, jbn.G1, jbn.G2)
    assert bn.g1_is_on_curve(bn.G1) and bn.g2_is_on_curve(bn.G2)
    assert bn.g1_mul(bn.FR, bn.G1) is None and bn.g2_mul(bn.FR, bn.G2) is None
    f = kzg.FrBN
    assert (f.p, f.generator, f.two_adicity) == (jkzg.FrBN.p, jkzg.FrBN.generator, 28)
    w = f.two_adic_root_of_unity
    assert w == jkzg.FrBN.two_adic_root_of_unity
    assert pow(w, 1 << 28, f.p) == 1 and pow(w, 1 << 27, f.p) != 1
    assert kzg.derive_h() == jkzg.derive_h()


def test_group_ops_match():
    rng = random.Random(1)
    for _ in range(3):
        a, b = rng.randrange(1, bn.FR), rng.randrange(1, bn.FR)
        p1, q1 = bn.g1_mul(a, bn.G1), bn.g2_mul(b, bn.G2)
        assert p1 == jbn.g1_mul(a, jbn.G1) and q1 == jbn.g2_mul(b, jbn.G2)
        assert bn.g1_add(p1, bn.G1) == jbn.g1_add(p1, jbn.G1)
        assert bn.g2_add(q1, bn.g2_neg(q1)) is None
        assert bn.g2_add(q1, bn.G2) == jbn.g2_add(q1, jbn.G2)


def test_pairing_values_and_bilinearity():
    rng = random.Random(3)
    a = rng.randrange(1, bn.FR)
    b = rng.randrange(1, bn.FR)
    e = bn.pairing(bn.G1, bn.G2)
    assert e == jbn.pairing(jbn.G1, jbn.G2)
    assert e != bn.F12_ONE
    assert bn.f12_pow(e, bn.FR) == bn.F12_ONE
    lhs = bn.pairing(bn.g1_mul(a, bn.G1), bn.g2_mul(b, bn.G2))
    assert lhs == bn.f12_pow(e, a * b % bn.FR)
    assert lhs == jbn.pairing(jbn.g1_mul(a, jbn.G1), jbn.g2_mul(b, jbn.G2))


def test_multi_pairing_cancellation():
    a = 987654321
    aP, aQ = bn.g1_mul(a, bn.G1), bn.g2_mul(a, bn.G2)
    assert bn.multi_pairing([(aP, bn.G2), (bn.g1_neg(bn.G1), aQ)])
    assert not bn.multi_pairing([(aP, bn.G2), (bn.g1_neg(bn.G1), bn.G2)])


class TestKZG:
    def setup_method(self):
        self.rng, self.jrng = Rng(42), Rng(42)
        self.srs = kzg.PairingSRS.create_trusted_setup(0x1CEB00DA, 8)
        self.jsrs = jkzg.PairingSRS.create_trusted_setup(0x1CEB00DA, 8)
        r = bn.FR
        self.zeta, self.zw, self.polyscale = (self.rng.field(r) for _ in range(3))
        for _ in range(3):
            self.jrng.field(r)

    def _evals(self, mod, poly, comm, nchunks=1):
        n = self.srs.max_poly_size
        return mod.KZGEvaluation(
            commitment=comm,
            evaluations=[
                [_poly_eval(poly[i * n:(i + 1) * n], pt) for i in range(nchunks)]
                for pt in (self.zeta, self.zw)
            ],
        )

    def test_setup_matches(self):
        assert (self.srs.g, self.srs.h, self.srs.g2) == (self.jsrs.g, self.jsrs.h, self.jsrs.g2)

    def test_open_verify_two_polys(self):
        r = bn.FR
        elm = [self.zeta, self.zw]
        p1 = [self.rng.field(r) for _ in range(8)]
        p2 = [self.rng.field(r) for _ in range(5)]
        for _ in range(13):
            self.jrng.field(r)
        c1, b1 = self.srs.commit(p1, 1, self.rng)
        jc1, jb1 = self.jsrs.commit(p1, 1, self.jrng)
        assert (c1, b1) == (jc1, jb1)
        c2 = self.srs.commit_non_hiding(p2, 1)
        assert c2 == self.jsrs.commit_non_hiding(p2, 1)
        proof = kzg.create(self.srs, [(p1, b1), (p2, [0])], elm, self.polyscale)
        jproof = jkzg.create(self.jsrs, [(p1, jb1), (p2, [0])], elm, self.polyscale)
        assert proof is not None
        assert (proof.quotient, proof.blinding) == (jproof.quotient, jproof.blinding)
        evals = [self._evals(kzg, p1, c1), self._evals(kzg, p2, c2)]
        assert kzg.combine_evaluations(evals, self.polyscale) == jkzg.combine_evaluations(
            [self._evals(jkzg, p1, c1), self._evals(jkzg, p2, c2)], self.polyscale)
        assert kzg.verify(self.srs, evals, self.polyscale, elm, proof)

        bad = [self._evals(kzg, p1, c1), self._evals(kzg, p2, c2)]
        bad[0].evaluations[0][0] = (bad[0].evaluations[0][0] + 1) % r
        assert not kzg.verify(self.srs, bad, self.polyscale, elm, proof)
        assert not kzg.verify(self.srs, evals, self.polyscale, elm,
                              kzg.KZGProof(proof.quotient, (proof.blinding + 1) % r))

    def test_chunked(self):
        r = bn.FR
        elm = [self.zeta, self.zw]
        p3 = [self.rng.field(r) for _ in range(20)]  # 3 chunks of 8
        for _ in range(20):
            self.jrng.field(r)
        c3, b3 = self.srs.commit(p3, 3, self.rng)
        assert (c3, b3) == self.jsrs.commit(p3, 3, self.jrng)
        proof = kzg.create(self.srs, [(p3, b3)], elm, self.polyscale)
        jproof = jkzg.create(self.jsrs, [(p3, b3)], elm, self.polyscale)
        assert (proof.quotient, proof.blinding) == (jproof.quotient, jproof.blinding)
        assert kzg.verify(self.srs, [self._evals(kzg, p3, c3, nchunks=3)], self.polyscale,
                          elm, proof)
