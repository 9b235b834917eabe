"""Mina-protocol compatibility layer: ROInput hashing and Schnorr signatures
(reference crates: hasher/, signer/)."""

from .hasher import ROInput, create_kimchi, create_legacy, poseidon_hasher
from .signer import Keypair, Signature, schnorr_sign, schnorr_verify, derive_nonce

__all__ = [
    "ROInput",
    "create_kimchi",
    "create_legacy",
    "poseidon_hasher",
    "Keypair",
    "Signature",
    "schnorr_sign",
    "schnorr_verify",
    "derive_nonce",
]
