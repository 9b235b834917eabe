"""Mina base58check key serialization (signer/src/{seckey,pubkey}.rs,
crates/mina-base58).

  - secret keys: [0x5a, 0x01] ++ 32-byte LE scalar ++ sha256d[..4]
    (seckey.rs:93-160)
  - addresses (B62…): [0xcb, 0x01, 0x01] ++ 32-byte LE x ++ y-parity
    byte ++ sha256d[..4] (pubkey.rs:258-278)
"""

from __future__ import annotations

import hashlib

from ..curves import Pallas

ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def b58_encode(data: bytes) -> str:
    v = int.from_bytes(data, "big")
    out = ""
    while v:
        v, r = divmod(v, 58)
        out = ALPHABET[r] + out
    pad = len(data) - len(data.lstrip(b"\x00"))
    return "1" * pad + out


def b58_decode(s: str) -> bytes:
    v = 0
    for ch in s:
        v = v * 58 + ALPHABET.index(ch)
    raw = v.to_bytes((v.bit_length() + 7) // 8, "big") if v else b""
    pad = len(s) - len(s.lstrip("1"))
    return bytes(pad) + raw


def _checksum(body: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(body).digest()).digest()[:4]


def _encode_checked(body: bytes) -> str:
    return b58_encode(body + _checksum(body))


def _decode_checked(s: str) -> bytes:
    raw = b58_decode(s)
    body, chk = raw[:-4], raw[-4:]
    if _checksum(body) != chk:
        raise ValueError("base58 checksum mismatch")
    return body


def seckey_to_base58(secret: int) -> str:
    return _encode_checked(bytes([0x5A, 0x01]) + secret.to_bytes(32, "little"))


def seckey_from_base58(s: str) -> int:
    body = _decode_checked(s)
    if body[:2] != bytes([0x5A, 0x01]):
        raise ValueError("invalid secret key version")
    return int.from_bytes(body[2:], "little")


def pubkey_to_address(point: tuple[int, int]) -> str:
    x, y = point
    body = bytes([0xCB, 0x01, 0x01]) + x.to_bytes(32, "little") + bytes([y & 1])
    return _encode_checked(body)


def pubkey_from_address(addr: str) -> tuple[int, int]:
    body = _decode_checked(addr)
    if body[:3] != bytes([0xCB, 0x01, 0x01]):
        raise ValueError("invalid address version")
    x = int.from_bytes(body[3:35], "little")
    is_odd = body[35] == 1
    f = Pallas.base
    y = f.sqrt(Pallas.curve_eqn(x))
    if y is None:
        raise ValueError("x not on curve")
    if (y & 1) != int(is_odd):
        y = f.p - y
    return (x, y)
