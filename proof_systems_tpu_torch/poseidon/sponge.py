"""Fiat-Shamir transcript sponges (host, exact).

Counterpart of proof_systems_tpu/poseidon/sponge.py, with the semantics of
poseidon/src/poseidon.rs (the ArithmeticSponge state machine) and
poseidon/src/sponge.rs (DefaultFqSponge / DefaultFrSponge, the 128-bit
ScalarChallenge and its endomorphism expansion). The transcript is
sequential and small, so it lives on the host; inside the IPA round loop
the card runs the same absorb/permute/squeeze steps in K10
(ops/kernels.sponge_squeeze2) and the host replays them afterwards.
"""

from __future__ import annotations

from ..curves import CurveParams
from ..fields import FieldParams
from .params import PoseidonParams
from .permutation import poseidon_block_cipher

# 64-bit limbs in a squeezed scalar challenge (sponge.rs:54).
CHALLENGE_LENGTH_IN_LIMBS = 2
# Limbs of a squeezed element kept as challenge entropy (sponge.rs:56).
HIGH_ENTROPY_LIMBS = 2


class ScalarChallenge:
    """A 128-bit challenge, expanded to a full scalar through the GLV
    endomorphism (sponge.rs:122-227, Halo sec. 6.2)."""

    def __init__(self, value: int):
        self.value = value

    def to_field_with_length(self, length_in_bits: int, endo_coeff: int, field: FieldParams) -> int:
        p = field.p
        rep = self.value
        a, b = 2, 2
        for i in reversed(range(length_in_bits // 2)):
            a = 2 * a % p
            b = 2 * b % p
            s = 1 if (rep >> (2 * i)) & 1 else p - 1
            if (rep >> (2 * i + 1)) & 1:
                a = (a + s) % p
            else:
                b = (b + s) % p
        return (a * endo_coeff + b) % p

    def to_field(self, endo_coeff: int, field: FieldParams) -> int:
        return self.to_field_with_length(64 * CHALLENGE_LENGTH_IN_LIMBS, endo_coeff, field)


class ArithmeticSponge:
    """Width-3 rate-2 sponge state machine (poseidon/src/poseidon.rs:60-152)."""

    def __init__(self, params: PoseidonParams):
        self.params = params
        self.state = [0, 0, 0]
        self.mode = "absorbed"  # "absorbed" | "squeezed"
        self.count = 0

    def absorb(self, x: int) -> None:
        p = self.params.field.p
        if self.mode == "absorbed":
            if self.count == self.params.sponge_rate:
                poseidon_block_cipher(self.params, self.state)
                self.count = 1
                self.state[0] = (self.state[0] + x) % p
            else:
                self.state[self.count] = (self.state[self.count] + x) % p
                self.count += 1
        else:
            self.state[0] = (self.state[0] + x) % p
            self.mode = "absorbed"
            self.count = 1

    def squeeze(self) -> int:
        if self.mode == "squeezed" and self.count != self.params.sponge_rate:
            out = self.state[self.count]
            self.count += 1
            return out
        poseidon_block_cipher(self.params, self.state)
        self.mode = "squeezed"
        self.count = 1
        return self.state[0]


def _limbs_le(x: int, n: int = 4) -> list[int]:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def _pack_limbs(limbs: list[int]) -> int:
    out = 0
    for limb in reversed(limbs):
        out = (out << 64) | limb
    return out


class FqSponge:
    """Sponge over the curve's base field, producing scalar-field challenges
    (DefaultFqSponge, sponge.rs:230-410). Over Vesta the base field is Fq
    and the scalar field Fp."""

    def __init__(self, params: PoseidonParams, curve: CurveParams):
        if params.field != curve.base:
            raise ValueError("the sponge must run over the curve's base field")
        self.sponge = ArithmeticSponge(params)
        self.curve = curve
        self.last_squeezed: list[int] = []

    def absorb_fq(self, xs: list[int]) -> None:
        self.last_squeezed = []
        for x in xs:
            self.sponge.absorb(x)

    def absorb_g(self, pts) -> None:
        """Points absorbed as (x, y); infinity as (0, 0) (sponge.rs:332-345)."""
        self.last_squeezed = []
        for pt in pts:
            x, y = (0, 0) if pt is None else pt
            self.sponge.absorb(x)
            self.sponge.absorb(y)

    def absorb_fr(self, xs: list[int]) -> None:
        """Scalar-field elements absorbed across the field boundary
        (sponge.rs:355-386): directly when |Fr| < |Fq|, else as (high bits,
        low bit)."""
        self.last_squeezed = []
        for x in xs:
            if self.curve.scalar.p < self.curve.base.p:
                self.sponge.absorb(x)
            else:
                self.sponge.absorb(x >> 1)
                self.sponge.absorb(x & 1)

    def squeeze_limbs(self, num_limbs: int) -> list[int]:
        while len(self.last_squeezed) < num_limbs:
            x = self.sponge.squeeze()
            self.last_squeezed.extend(_limbs_le(x)[:HIGH_ENTROPY_LIMBS])
        out = self.last_squeezed[:num_limbs]
        self.last_squeezed = self.last_squeezed[num_limbs:]
        return out

    def squeeze_field(self) -> int:
        self.last_squeezed = []
        return self.sponge.squeeze()

    def challenge(self) -> ScalarChallenge:
        """128-bit scalar challenge (sponge.rs:403-405)."""
        return ScalarChallenge(_pack_limbs(self.squeeze_limbs(CHALLENGE_LENGTH_IN_LIMBS)))

    def challenge_fq(self) -> int:
        return self.squeeze_field()

    def squeeze_scalar_challenge_and_expand(self) -> int:
        """challenge() expanded through the scalar-field endo coefficient."""
        _, endo_r = self.curve.endos
        return self.challenge().to_field(endo_r, self.curve.scalar)

    def digest(self) -> int:
        """Squeeze and reduce into the scalar field; out of range gives 0
        (the (q-p)/q bias of sponge.rs:388-397, kept for compatibility)."""
        x = self.squeeze_field()
        return x if x < self.curve.scalar.p else 0

    def digest_fq(self) -> int:
        return self.squeeze_field()

    def clone(self) -> "FqSponge":
        out = FqSponge.__new__(FqSponge)
        out.curve = self.curve
        out.sponge = ArithmeticSponge(self.sponge.params)
        out.sponge.state = list(self.sponge.state)
        out.sponge.mode = self.sponge.mode
        out.sponge.count = self.sponge.count
        out.last_squeezed = list(self.last_squeezed)
        return out


class FrSponge:
    """Sponge over the scalar field (DefaultFrSponge, sponge.rs:262-278)."""

    def __init__(self, params: PoseidonParams):
        self.sponge = ArithmeticSponge(params)
        self.field = params.field
        self.last_squeezed: list[int] = []

    def absorb(self, x: int) -> None:
        self.last_squeezed = []
        self.sponge.absorb(x)

    def absorb_multiple(self, xs: list[int]) -> None:
        self.last_squeezed = []
        for x in xs:
            self.sponge.absorb(x)

    def squeeze(self, num_limbs: int) -> int:
        while len(self.last_squeezed) < num_limbs:
            x = self.sponge.squeeze()
            self.last_squeezed.extend(_limbs_le(x)[:HIGH_ENTROPY_LIMBS])
        out = self.last_squeezed[:num_limbs]
        self.last_squeezed = self.last_squeezed[num_limbs:]
        return _pack_limbs(out)

    def challenge(self) -> ScalarChallenge:
        return ScalarChallenge(self.squeeze(CHALLENGE_LENGTH_IN_LIMBS))

    def digest(self) -> int:
        """plonk_sponge.rs digest: squeeze one full field element."""
        return self.sponge.squeeze()


def poseidon_hash(params: PoseidonParams, inputs: list[int]) -> int:
    """Hash a fixed-length list of field elements (absorb all, squeeze one)."""
    sponge = ArithmeticSponge(params)
    for x in inputs:
        sponge.absorb(x)
    return sponge.squeeze()
