"""Mina ROInput hashing (reference: hasher/src/{roinput,lib,poseidon}.rs).

ROInput packs fields and bits into the random-oracle input format
(roinput.rs:60-250): bits are accumulated LSB-first per byte; to_fields
appends the bit stream chunked into 254-bit field elements. Hashers are
domain-separated by absorbing `domain_prefix_to_field(domain_string)`
('*'-padded to 20 chars, lib.rs:179-190) and snapshotting the sponge
state for cheap reset.
"""

from __future__ import annotations

from ..fields import Fp, Fq
from ..poseidon import PoseidonParams, fp_kimchi, fp_legacy
from ..poseidon.sponge import ArithmeticSponge

MAX_DOMAIN_STRING_LEN = 20


class ROInput:
    def __init__(self):
        self.fields: list[int] = []
        self.bits: list[int] = []

    # -- builders (all return self for chaining) ---------------------------

    def append_roinput(self, other: "ROInput") -> "ROInput":
        self.fields.extend(other.fields)
        self.bits.extend(other.bits)
        return self

    def append_field(self, x: int) -> "ROInput":
        self.fields.append(x % Fp.p)
        return self

    def append_scalar(self, s: int) -> "ROInput":
        """255 bits of the scalar, LSB first (roinput.rs append_scalar)."""
        for i in range(255):
            self.bits.append((s >> i) & 1)
        return self

    def append_bool(self, b: bool) -> "ROInput":
        self.bits.append(1 if b else 0)
        return self

    def append_bytes(self, data: bytes) -> "ROInput":
        for byte in data:
            for i in range(8):
                self.bits.append((byte >> i) & 1)
        return self

    def append_u32(self, x: int) -> "ROInput":
        return self.append_bytes(x.to_bytes(4, "little"))

    def append_u64(self, x: int) -> "ROInput":
        return self.append_bytes(x.to_bytes(8, "little"))

    # -- packing -----------------------------------------------------------

    def to_bytes(self) -> bytes:
        bits: list[int] = []
        for f in self.fields:
            for i in range(255):
                bits.append((f >> i) & 1)
        bits.extend(self.bits)
        out = bytearray((len(bits) + 7) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def to_fields(self) -> list[int]:
        """fields ++ bits chunked into 254-bit little-endian field elements."""
        out = list(self.fields)
        for start in range(0, len(self.bits), 254):
            chunk = self.bits[start : start + 254]
            v = 0
            for i, b in enumerate(chunk):
                v |= b << i
            out.append(v)
        return out


def domain_prefix_to_field(prefix: str) -> int:
    assert len(prefix) <= MAX_DOMAIN_STRING_LEN
    padded = prefix.ljust(MAX_DOMAIN_STRING_LEN, "*").encode()
    padded = padded + bytes(32 - len(padded))
    return int.from_bytes(padded, "little")


class PoseidonHasher:
    """Domain-separated reusable hashing context (hasher/src/poseidon.rs)."""

    def __init__(self, params: PoseidonParams, domain_string: str | None):
        self.params = params
        self.domain_string = domain_string
        self._init_state = [0, 0, 0]
        self.sponge = ArithmeticSponge(params)
        self.init(domain_string)

    def init(self, domain_string: str | None) -> "PoseidonHasher":
        self.sponge = ArithmeticSponge(self.params)
        if domain_string is not None:
            self.sponge.absorb(domain_prefix_to_field(domain_string))
            self.sponge.squeeze()
        self._init_state = list(self.sponge.state)
        self._init_mode = self.sponge.mode
        self._init_count = self.sponge.count
        return self

    def reset(self) -> "PoseidonHasher":
        self.sponge.state = list(self._init_state)
        self.sponge.mode = self._init_mode
        self.sponge.count = self._init_count
        return self

    def update(self, roi: ROInput) -> "PoseidonHasher":
        for f in roi.to_fields():
            self.sponge.absorb(f)
        return self

    def digest(self) -> int:
        out = self.sponge.squeeze()
        self.reset()
        return out

    def hash(self, roi: ROInput) -> int:
        self.reset()
        self.update(roi)
        out = self.digest()
        self.reset()
        return out


def create_legacy(domain_string: str | None) -> PoseidonHasher:
    return PoseidonHasher(fp_legacy, domain_string)


def create_kimchi(domain_string: str | None) -> PoseidonHasher:
    return PoseidonHasher(fp_kimchi, domain_string)


def poseidon_hasher(kind: str, domain_string: str | None) -> PoseidonHasher:
    return create_legacy(domain_string) if kind == "legacy" else create_kimchi(domain_string)
