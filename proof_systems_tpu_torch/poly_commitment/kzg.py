"""KZG10 pairing-based polynomial commitment over BN254.

Capability mirror of poly-commitment/src/kzg.rs (KZGProof:94,
PairingSRS:129, create:407, verify:446) — the reference's alternative
PCS for EVM-targeting users. Same protocol shape:

  - trusted setup: G1 powers tau^i . G (+ a blinder H), and a 3-element
    G2 SRS for committing the degree-2 divisor polynomial
    (ipa.rs:396-426 create_trusted_setup_with_toxic_waste).
  - open([polys], [zeta, zeta*omega], polyscale): fold everything with
    powers of polyscale, interpolate the line through the two
    evaluations, divide by (x-z1)(x-z2), commit the quotient; the
    aggregate blinding factor rides along in the clear (kzg.rs:94-100).
  - verify: fold the commitments the same way and check
        e(C - E - bH, G2) == e(pi, D)
    with D the G2 commitment to the divisor and E the G1 commitment to
    the interpolated line — one product of two Miller loops and a single
    final exponentiation (kzg.rs:487-505).

Host-side by design: KZG is the compatibility backend; the card's path
belongs to the IPA pipeline (poly_commitment/ipa.py), whose kernels take
only the Pasta moduli. Pairings come from
proof_systems_tpu_torch.pairing.bn254.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..fields import FieldParams
from ..pairing import bn254 as bn

# BN254 scalar field with arkworks parameters (ark-bn254 Fr: 2-adicity
# 28, multiplicative generator 5) so the existing domain/NTT host tools
# apply unchanged.
FrBN = FieldParams(name="FrBN254", p=bn.FR, generator=5, two_adicity=28)


def _commit_g1(points, coeffs: list[int]):
    acc = None
    for c, pt in zip(coeffs, points):
        if c % bn.FR:
            acc = bn.g1_add(acc, bn.g1_mul(c, pt))
    return acc


def _commit_g2(points, coeffs: list[int]):
    acc = None
    for c, pt in zip(coeffs, points):
        if c % bn.FR:
            acc = bn.g2_add(acc, bn.g2_mul(c, pt))
    return acc


def derive_h():
    """Deterministic blinder point: blake2b("srs_misc" || be32(0)) hashed
    to an x-coordinate by try-and-increment.

    The reference maps the digest through the SvdW group map on the IPA
    curve (ipa.rs:407-419); BN254 carries no group-map instance in the
    reference, so the blinder derivation is fixed here instead (it only
    needs to be a point of unknown discrete log)."""
    seed = hashlib.blake2b(b"srs_misc" + (0).to_bytes(4, "big"), digest_size=64).digest()
    x = int.from_bytes(seed[:31], "little") % bn.FQ
    while True:
        rhs = (x * x * x + bn.B1) % bn.FQ
        y = pow(rhs, (bn.FQ + 1) // 4, bn.FQ)
        if y * y % bn.FQ == rhs:
            # clear the cofactor (1 for BN254 G1 — kept for clarity)
            return (x, min(y, bn.FQ - y))
        x = (x + 1) % bn.FQ


@dataclass
class PairingSRS:
    """full_srs: G1 powers (prover key); verifier_srs: G2 powers, size 3
    (kzg.rs:129-160)."""

    g: list  # G1 points, g[i] = tau^i . G1
    h: tuple  # G1 blinder
    g2: list  # G2 points, g2[i] = tau^i . G2 (len 3)

    @classmethod
    def create_trusted_setup(cls, toxic_waste: int, depth: int) -> "PairingSRS":
        tau = toxic_waste % bn.FR
        g, acc = [], 1
        for _ in range(depth):
            g.append(bn.g1_mul(acc, bn.G1))
            acc = acc * tau % bn.FR
        g2, acc = [], 1
        for _ in range(3):
            g2.append(bn.g2_mul(acc, bn.G2))
            acc = acc * tau % bn.FR
        return cls(g=g, h=derive_h(), g2=g2)

    @property
    def max_poly_size(self) -> int:
        return len(self.g)

    def commit_non_hiding(self, coeffs: list[int], num_chunks: int = 1) -> list:
        """Chunked commitment: one G1 point per max_poly_size coefficients
        (lib.rs commit_non_hiding semantics)."""
        n = self.max_poly_size
        chunks = []
        for i in range(0, max(len(coeffs), 1), n):
            chunks.append(_commit_g1(self.g, [c % bn.FR for c in coeffs[i : i + n]]))
        while len(chunks) < num_chunks:
            chunks.append(None)
        return chunks

    def commit(self, coeffs: list[int], num_chunks: int, rng) -> tuple[list, list[int]]:
        """Hiding commitment: chunk_i + blinder_i . H, returning
        (chunks, blinders)."""
        chunks = self.commit_non_hiding(coeffs, num_chunks)
        blinders = [rng.field(bn.FR) for _ in chunks]
        masked = [bn.g1_add(c, bn.g1_mul(b, self.h)) for c, b in zip(chunks, blinders)]
        return masked, blinders


@dataclass
class KZGEvaluation:
    """One opened polynomial: chunked commitment + its evaluations,
    indexed [eval_point][chunk] (commitment.rs Evaluation)."""

    commitment: list  # G1 chunks
    evaluations: list[list[int]]


@dataclass
class KZGProof:
    quotient: tuple  # G1
    blinding: int  # aggregate blinding factor, in the clear (kzg.rs:99)


def _eval_line(elm: list[int], evals: list[int]) -> list[int]:
    """Degree-1 interpolant through (elm[i], evals[i]) (kzg.rs:352-380)."""
    z1, z2 = elm
    e1, e2 = evals
    r = bn.FR
    b = (e2 - e1) * pow((z2 - z1) % r, -1, r) % r
    a = (e1 - b * z1) % r
    return [a, b]


def _divisor(elm: list[int]) -> list[int]:
    """(x - z1)(x - z2) coefficients low-to-high (kzg.rs:383-388)."""
    z1, z2 = elm
    r = bn.FR
    return [z1 * z2 % r, (-(z1 + z2)) % r, 1]


def _divide_linear(coeffs: list[int], z: int) -> tuple[list[int], int]:
    """coeffs / (x - z) by synthetic division -> (quotient, remainder)."""
    r = bn.FR
    q = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (coeffs[i] + acc * z) % r if i < len(coeffs) - 1 else coeffs[i] % r
        q[i - 1] = acc
    rem = (coeffs[0] + acc * z) % r
    return q, rem


def _poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % bn.FR
    return acc


def create(
    srs: PairingSRS,
    plnms: list[tuple[list[int], list[int]]],
    elm: list[int],
    polyscale: int,
) -> KZGProof | None:
    """Open the polyscale-fold of `plnms` at the two points of `elm`
    (kzg.rs:407-441 KZGProof::create).

    plnms: list of (coefficients, chunk_blinders); every
    max_poly_size-coefficient chunk consumes one power of polyscale,
    exactly like the IPA's combine_polys."""
    r = bn.FR
    n = srs.max_poly_size
    combined: list[int] = []
    blinding = 0
    scale = 1
    for coeffs, blinders in plnms:
        nchunks = max(1, -(-len(coeffs) // n))
        for i in range(nchunks):
            chunk = coeffs[i * n : (i + 1) * n]
            for j, c in enumerate(chunk):
                if j >= len(combined):
                    combined.extend([0] * (j + 1 - len(combined)))
                combined[j] = (combined[j] + c * scale) % r
            if i < len(blinders):
                blinding = (blinding + blinders[i] * scale) % r
            scale = scale * polyscale % r
    if not combined:
        combined = [0]

    evals = [_poly_eval(combined, pt) for pt in elm]
    line = _eval_line(elm, evals)
    numer = list(combined)
    for j in range(2):
        numer[j] = (numer[j] - line[j]) % r
    q1, rem1 = _divide_linear(numer, elm[0])
    if rem1:
        return None
    q2, rem2 = _divide_linear(q1, elm[1]) if len(q1) > 1 else ([0], q1[0] if q1 else 0)
    if rem2:
        return None
    quotient = srs.commit_non_hiding(q2, 1)[0]
    return KZGProof(quotient=quotient, blinding=blinding)


def combine_evaluations(evaluations: list[KZGEvaluation], polyscale: int) -> list[int]:
    """Accumulate evaluations with powers of polyscale (kzg.rs:61-87):
    one power per chunk, shared across eval points."""
    r = bn.FR
    if not evaluations:
        return []
    npts = len(evaluations[0].evaluations)
    acc = [0] * npts
    scale = 1
    for ev in evaluations:
        if not ev.commitment:
            continue
        nchunks = len(ev.evaluations[0])
        for c in range(nchunks):
            for pt in range(npts):
                acc[pt] = (acc[pt] + ev.evaluations[pt][c] * scale) % r
            scale = scale * polyscale % r
    return acc


def verify(
    srs: PairingSRS,
    evaluations: list[KZGEvaluation],
    polyscale: int,
    elm: list[int],
    proof: KZGProof,
) -> bool:
    """kzg.rs:446-505 KZGProof::verify."""
    r = bn.FR
    # fold the commitments with the same powers of polyscale
    poly_comm = None
    scale = 1
    for ev in evaluations:
        for chunk in ev.commitment:
            poly_comm = bn.g1_add(poly_comm, bn.g1_mul(scale, chunk))
            scale = scale * polyscale % r
    evals = combine_evaluations(evaluations, polyscale)
    line = _eval_line(elm, evals)
    eval_comm = srs.commit_non_hiding(line, 1)[0]
    blind_comm = bn.g1_mul(proof.blinding, srs.h)
    numerator = bn.g1_add(poly_comm, bn.g1_neg(bn.g1_add(eval_comm, blind_comm)))
    divisor_comm = _commit_g2(srs.g2, _divisor(elm))
    # e(numerator, G2) * e(-quotient, divisor) == 1
    return bn.multi_pairing(
        [(numerator, bn.G2), (bn.g1_neg(proof.quotient), divisor_comm)]
    )
