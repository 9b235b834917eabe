"""Mina Schnorr signatures over Pallas (reference: signer/src/schnorr.rs).

sign (schnorr.rs:105-117): derive deterministic nonce k (blake2b-256 of
the packed message+keys+network bits, top 2 bits dropped), R = kG with
k negated if R.y is odd, challenge e = H(input ‖ px ‖ py ‖ rx) via the
domain-separated hasher, s = k + e·sk. verify (schnorr.rs:119-146):
R' = sG − eP, require R'.y even and R'.x == rx.

Network-id domain strings: "MinaSignatureMainnet" / "CodaSignature"
(testnet) — signer/src/lib.rs NetworkId.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..curves import Pallas
from .hasher import PoseidonHasher, ROInput, create_kimchi, create_legacy

BaseField = Pallas.base  # Fp
ScalarField = Pallas.scalar  # Fq


@dataclass
class Keypair:
    secret: int  # scalar

    @property
    def public(self) -> tuple[int, int]:
        return Pallas.scalar_mul(self.secret, Pallas.generator)


@dataclass
class Signature:
    rx: int
    s: int


NETWORK_TESTNET = 0x00
NETWORK_MAINNET = 0x01


def _message_roi(roi: ROInput, pub: tuple[int, int], rx: int) -> ROInput:
    out = ROInput()
    out.append_roinput(roi)
    out.append_field(pub[0])
    out.append_field(pub[1])
    out.append_field(rx)
    return out


def derive_nonce(kp: Keypair, roi: ROInput, network_id: int) -> int:
    """Chunked nonce derivation (schnorr.rs:216-288, o1js compatible)."""
    pub = kp.public
    secret = kp.secret
    # Field.project: reduce the scalar into the base field representation
    secret_as_base = secret - BaseField.p if secret >= BaseField.p else secret

    inp = ROInput()
    inp.append_roinput(roi)
    inp.append_field(pub[0])
    inp.append_field(pub[1])
    inp.append_field(secret_as_base)
    inp.append_bytes(bytes([network_id]))

    packed = inp.to_fields()
    bits: list[int] = []
    for fval in packed:
        for i in range(255):
            bits.append((fval >> i) & 1)
    data = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            data[i // 8] |= 1 << (i % 8)

    digest = bytearray(hashlib.blake2b(bytes(data), digest_size=32).digest())
    digest[-1] &= 0b0011_1111
    return int.from_bytes(bytes(digest), "little") % ScalarField.p


def _message_hash(
    hasher: PoseidonHasher, roi: ROInput, pub: tuple[int, int], rx: int
) -> int:
    return hasher.hash(_message_roi(roi, pub, rx)) % ScalarField.p


def _hasher_for(network_id: int, legacy: bool) -> PoseidonHasher:
    domain = "MinaSignatureMainnet" if network_id == NETWORK_MAINNET else "CodaSignature"
    return create_legacy(domain) if legacy else create_kimchi(domain)


def schnorr_sign(
    kp: Keypair, roi: ROInput, network_id: int = NETWORK_TESTNET, legacy: bool = False
) -> Signature:
    k = derive_nonce(kp, roi, network_id)
    r_pt = Pallas.scalar_mul(k, Pallas.generator)
    if r_pt[1] % 2 == 1:
        k = (-k) % ScalarField.p
    hasher = _hasher_for(network_id, legacy)
    e = _message_hash(hasher, roi, kp.public, r_pt[0])
    s = (k + e * kp.secret) % ScalarField.p
    return Signature(rx=r_pt[0], s=s)


def schnorr_verify(
    sig: Signature,
    public: tuple[int, int],
    roi: ROInput,
    network_id: int = NETWORK_TESTNET,
    legacy: bool = False,
) -> bool:
    hasher = _hasher_for(network_id, legacy)
    ev = _message_hash(hasher, roi, public, sig.rx)
    sv = Pallas.scalar_mul(sig.s, Pallas.generator)
    rv = Pallas.add(sv, Pallas.neg(Pallas.scalar_mul(ev, public)))
    if rv is None:
        return False
    return rv[1] % 2 == 0 and rv[0] == sig.rx
