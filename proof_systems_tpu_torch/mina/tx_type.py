"""Mina Protocol transaction types (reference: mina-tx-type/src/).

Standalone, dependency-light transaction type definitions mirroring the
reference crate's semantics exactly:

  - currency (mina-tx-type/src/currency.rs): `Amount` / `Fee` are u64
    nanomina newtypes with checked arithmetic; `Signed` keeps magnitude
    and `Sign` separately (NOT two's complement) and normalizes zero to
    positive sign.
  - coinbase (mina-tx-type/src/coinbase.rs): `Coinbase` block-reward
    transactions with an optional `CoinbaseFeeTransfer` to a SNARK
    worker; `net_amount` = amount − fee (None on underflow).

`CompressedPubKey` is the (x, is_odd) affine compression used across
the Mina stack (signer's CompressedPubKey); `to_roinput` provides the
random-oracle input layout (x as a base-field element, parity as one
bool bit) so these types compose with mina/hasher.py's domain-separated
Poseidon hashing the same way the reference types compose with
mina-hasher's `Hashable`.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

from ..curves import Pallas
from .hasher import ROInput

U64_MAX = (1 << 64) - 1


class Sign(Enum):
    """Sign of a value (currency.rs Sign); default positive."""

    POS = 1
    NEG = -1

    def is_pos(self) -> bool:
        return self is Sign.POS

    def is_neg(self) -> bool:
        return self is Sign.NEG

    def __neg__(self) -> "Sign":
        return Sign.NEG if self is Sign.POS else Sign.POS

    def __str__(self) -> str:
        return "+" if self is Sign.POS else "-"


class _U64Newtype:
    """u64 magnitude newtype with checked arithmetic (currency.rs
    impl_number!). Subclasses: Amount, Fee."""

    __slots__ = ("_v",)
    ZERO: "_U64Newtype"

    def __init__(self, value: int = 0):
        if not 0 <= value <= U64_MAX:
            raise ValueError(f"{type(self).__name__} out of u64 range: {value}")
        self._v = value

    @classmethod
    def new(cls, value: int):
        return cls(value)

    def inner(self) -> int:
        return self._v

    def is_zero(self) -> bool:
        return self._v == 0

    def abs_diff(self, other):
        return type(self)(abs(self._v - other._v))

    def checked_add(self, other):
        r = self._v + other._v
        return None if r > U64_MAX else type(self)(r)

    def checked_sub(self, other):
        r = self._v - other._v
        return None if r < 0 else type(self)(r)

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._v == other._v

    def __lt__(self, other):
        return self._v < other._v

    def __le__(self, other):
        return self._v <= other._v

    def __hash__(self):
        return hash((type(self).__name__, self._v))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._v})"

    def __str__(self) -> str:
        return str(self._v)

    def to_roinput(self) -> ROInput:
        return ROInput().append_u64(self._v)


class Amount(_U64Newtype):
    """Currency amount in nanomina (1 MINA = 1e9 nanomina)."""


class Fee(_U64Newtype):
    """Transaction fee in nanomina."""

    def to_amount(self) -> Amount:
        return Amount(self._v)


Amount.ZERO = Amount(0)
Fee.ZERO = Fee(0)


@dataclass(frozen=True)
class Signed:
    """Magnitude + sign pair (currency.rs Signed<T>); zero magnitude is
    always normalized to positive sign."""

    magnitude: _U64Newtype
    sign: Sign

    @staticmethod
    def new(magnitude: _U64Newtype, sign: Sign) -> "Signed":
        if magnitude.is_zero():
            sign = Sign.POS
        return Signed(magnitude, sign)

    @staticmethod
    def pos(magnitude: _U64Newtype) -> "Signed":
        return Signed.new(magnitude, Sign.POS)

    @staticmethod
    def neg(magnitude: _U64Newtype) -> "Signed":
        return Signed.new(magnitude, Sign.NEG)

    @staticmethod
    def zero(cls=Amount) -> "Signed":
        return Signed(cls(0), Sign.POS)

    def is_zero(self) -> bool:
        return self.magnitude.is_zero()

    def is_pos(self) -> bool:
        return self.sign.is_pos()

    def is_neg(self) -> bool:
        return self.sign.is_neg()

    def __neg__(self) -> "Signed":
        return Signed.new(self.magnitude, -self.sign)

    def checked_add(self, other: "Signed") -> Optional["Signed"]:
        if self.sign is other.sign:
            m = self.magnitude.checked_add(other.magnitude)
            return None if m is None else Signed.new(m, self.sign)
        if not self.magnitude < other.magnitude:
            return Signed.new(self.magnitude.abs_diff(other.magnitude), self.sign)
        return Signed.new(other.magnitude.abs_diff(self.magnitude), other.sign)

    def checked_sub(self, other: "Signed") -> Optional["Signed"]:
        return self.checked_add(-other)

    def __str__(self) -> str:
        return f"-{self.magnitude}" if self.is_neg() else str(self.magnitude)


@dataclass(frozen=True)
class CompressedPubKey:
    """Affine point compression (x, parity-of-y) used across the Mina
    stack (mina-signer CompressedPubKey)."""

    x: int
    is_odd: bool

    @staticmethod
    def empty() -> "CompressedPubKey":
        return CompressedPubKey(0, False)

    @staticmethod
    def from_point(pt: tuple[int, int]) -> "CompressedPubKey":
        return CompressedPubKey(pt[0], bool(pt[1] & 1))

    def decompress(self) -> Optional[tuple[int, int]]:
        """Recover the affine point; None if x is not on the curve."""
        y = Pallas.base.sqrt(Pallas.curve_eqn(self.x))
        if y is None:
            return None
        if bool(y & 1) != self.is_odd:
            y = Pallas.base.p - y
        return (self.x, y)

    def to_roinput(self) -> ROInput:
        return ROInput().append_field(self.x).append_bool(self.is_odd)


@dataclass(frozen=True)
class CoinbaseFeeTransfer:
    """Fee transfer to a SNARK worker within a coinbase
    (coinbase.rs CoinbaseFeeTransfer)."""

    receiver_pk: CompressedPubKey
    fee: Fee

    def to_roinput(self) -> ROInput:
        return (
            ROInput()
            .append_roinput(self.receiver_pk.to_roinput())
            .append_roinput(self.fee.to_roinput())
        )


@dataclass(frozen=True)
class Coinbase:
    """Block-reward transaction (coinbase.rs Coinbase)."""

    receiver: CompressedPubKey
    amount: Amount
    fee_transfer: Optional[CoinbaseFeeTransfer] = None

    @staticmethod
    def new(receiver: CompressedPubKey, amount: Amount) -> "Coinbase":
        return Coinbase(receiver, amount, None)

    @staticmethod
    def with_fee_transfer(
        receiver: CompressedPubKey,
        amount: Amount,
        fee_transfer: CoinbaseFeeTransfer,
    ) -> "Coinbase":
        return Coinbase(receiver, amount, fee_transfer)

    def has_fee_transfer(self) -> bool:
        return self.fee_transfer is not None

    def net_amount(self) -> Optional[Amount]:
        """amount − fee_transfer.fee; None on underflow
        (coinbase.rs net_amount)."""
        if self.fee_transfer is None:
            return self.amount
        return self.amount.checked_sub(self.fee_transfer.fee.to_amount())

    def to_roinput(self) -> ROInput:
        roi = (
            ROInput()
            .append_roinput(self.receiver.to_roinput())
            .append_roinput(self.amount.to_roinput())
        )
        roi.append_bool(self.fee_transfer is not None)
        if self.fee_transfer is not None:
            roi.append_roinput(self.fee_transfer.to_roinput())
        return roi
