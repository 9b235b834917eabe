"""Proof wire format: rmp-serde (MessagePack) compatible layout.

Counterpart of the proof half of proof_systems_tpu/serialization.py, host
code copied as it is; the verifier-index half comes with ROADMAP Queue 1
item 10.

Mirrors the reference serialization surface:
  - rmp-serde compact mode: structs -> fixarray of fields, Option ->
    nil | value, Vec -> array (kimchi/src/proof.rs serde derives;
    round-trip test at kimchi/src/tests/serde.rs:38-57),
  - curve points: arkworks serialize_compressed -> 33-byte bin
    (32-byte LE x + flag byte; 0x40 infinity, 0x80 larger y),
  - field elements: 32-byte LE bin (utils/src/serialization.rs).

The expected size for a 2^15-gate proof is 4,947 bytes (README.md:52).
"""

from __future__ import annotations

import io

from .curves import AffinePoint, CurveParams
from .poly_commitment.commitment import PolyComm
from .poly_commitment.ipa import OpeningProof
from .proof import (
    LookupCommitments,
    PointEvaluations,
    ProofEvaluations,
    ProverCommitments,
    ProverProof,
    RecursionChallenge,
)

# ---------------------------------------------------------------------------
# Minimal msgpack writer/reader (subset used by rmp-serde compact mode)
# ---------------------------------------------------------------------------


class Packer:
    def __init__(self):
        self.buf = io.BytesIO()

    def array(self, n: int) -> None:
        if n < 16:
            self.buf.write(bytes([0x90 | n]))
        elif n < 1 << 16:
            self.buf.write(b"\xdc" + n.to_bytes(2, "big"))
        else:
            self.buf.write(b"\xdd" + n.to_bytes(4, "big"))

    def bin(self, data: bytes) -> None:
        n = len(data)
        if n < 256:
            self.buf.write(b"\xc4" + bytes([n]))
        elif n < 1 << 16:
            self.buf.write(b"\xc5" + n.to_bytes(2, "big"))
        else:
            self.buf.write(b"\xc6" + n.to_bytes(4, "big"))
        self.buf.write(data)

    def nil(self) -> None:
        self.buf.write(b"\xc0")

    def bool(self, v: bool) -> None:
        self.buf.write(b"\xc3" if v else b"\xc2")

    def uint(self, v: int) -> None:
        if v < 0x80:
            self.buf.write(bytes([v]))
        elif v < 1 << 8:
            self.buf.write(b"\xcc" + bytes([v]))
        elif v < 1 << 16:
            self.buf.write(b"\xcd" + v.to_bytes(2, "big"))
        elif v < 1 << 32:
            self.buf.write(b"\xce" + v.to_bytes(4, "big"))
        else:
            self.buf.write(b"\xcf" + v.to_bytes(8, "big"))

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class Unpacker:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def array(self) -> int:
        b = self._byte()
        if b & 0xF0 == 0x90:
            return b & 0x0F
        if b == 0xDC:
            return int.from_bytes(self._take(2), "big")
        if b == 0xDD:
            return int.from_bytes(self._take(4), "big")
        raise ValueError(f"expected array, got {b:#x}")

    def bin(self) -> bytes:
        b = self._byte()
        if b == 0xC4:
            n = self._byte()
        elif b == 0xC5:
            n = int.from_bytes(self._take(2), "big")
        elif b == 0xC6:
            n = int.from_bytes(self._take(4), "big")
        else:
            raise ValueError(f"expected bin, got {b:#x}")
        return self._take(n)

    def peek_nil(self) -> bool:
        if self.data[self.pos] == 0xC0:
            self.pos += 1
            return True
        return False

    def bool(self) -> bool:
        b = self._byte()
        if b == 0xC3:
            return True
        if b == 0xC2:
            return False
        raise ValueError(f"expected bool, got {b:#x}")

    def uint(self) -> int:
        b = self._byte()
        if b < 0x80:
            return b
        if b == 0xCC:
            return self._byte()
        if b == 0xCD:
            return int.from_bytes(self._take(2), "big")
        if b == 0xCE:
            return int.from_bytes(self._take(4), "big")
        if b == 0xCF:
            return int.from_bytes(self._take(8), "big")
        raise ValueError(f"expected uint, got {b:#x}")


# ---------------------------------------------------------------------------
# arkworks-compatible primitives
# ---------------------------------------------------------------------------


def point_bytes(curve: CurveParams, pt: AffinePoint) -> bytes:
    if pt is None:
        return bytes(32) + bytes([0x40])
    x, y = pt
    flag = 0x80 if y > curve.base.p - y else 0x00
    return x.to_bytes(32, "little") + bytes([flag])


def point_from_bytes(curve: CurveParams, raw: bytes) -> AffinePoint:
    flag = raw[32]
    if flag & 0x40:
        return None
    x = int.from_bytes(raw[:32], "little")
    y = curve.base.sqrt(curve.curve_eqn(x))
    assert y is not None, "point not on curve"
    y_neg = curve.base.p - y
    big, small = (y, y_neg) if y > y_neg else (y_neg, y)
    return (x, big) if flag & 0x80 else (x, small)


def field_bytes(x: int) -> bytes:
    return x.to_bytes(32, "little")


# ---------------------------------------------------------------------------
# Proof serialization
# ---------------------------------------------------------------------------


def _pack_poly_comm(pk: Packer, curve: CurveParams, c: PolyComm) -> None:
    pk.array(1)
    pk.array(len(c.chunks))
    for ch in c.chunks:
        pk.bin(point_bytes(curve, ch))


def _pack_point_evals(pk: Packer, pe: PointEvaluations) -> None:
    pk.array(2)
    pk.array(len(pe.zeta))
    for v in pe.zeta:
        pk.bin(field_bytes(v))
    pk.array(len(pe.zeta_omega))
    for v in pe.zeta_omega:
        pk.bin(field_bytes(v))


def _pack_opt_point_evals(pk: Packer, pe) -> None:
    if pe is None:
        pk.nil()
    else:
        _pack_point_evals(pk, pe)


def serialize_proof(curve: CurveParams, proof: ProverProof) -> bytes:
    pk = Packer()
    pk.array(5)  # ProverProof fields

    # commitments: ProverCommitments { w_comm, z_comm, t_comm, lookup }
    pk.array(4)
    pk.array(15)
    for c in proof.commitments.w_comm:
        _pack_poly_comm(pk, curve, c)
    _pack_poly_comm(pk, curve, proof.commitments.z_comm)
    _pack_poly_comm(pk, curve, proof.commitments.t_comm)
    if proof.commitments.lookup is None:
        pk.nil()
    else:
        lk = proof.commitments.lookup
        pk.array(3)
        pk.array(len(lk.sorted))
        for c in lk.sorted:
            _pack_poly_comm(pk, curve, c)
        _pack_poly_comm(pk, curve, lk.aggreg)
        if lk.runtime is None:
            pk.nil()
        else:
            _pack_poly_comm(pk, curve, lk.runtime)

    # proof: OpeningProof { lr, delta, z1, z2, sg }
    op = proof.proof
    pk.array(5)
    pk.array(len(op.lr))
    for l, r in op.lr:
        pk.array(2)
        pk.bin(point_bytes(curve, l))
        pk.bin(point_bytes(curve, r))
    pk.bin(point_bytes(curve, op.delta))
    pk.bin(field_bytes(op.z1))
    pk.bin(field_bytes(op.z2))
    pk.bin(point_bytes(curve, op.sg))

    # evals: ProofEvaluations (field order of proof.rs:50-140)
    ev = proof.evals
    pk.array(26)
    _pack_opt_point_evals(pk, ev.public)
    pk.array(15)
    for w in ev.w:
        _pack_point_evals(pk, w)
    _pack_point_evals(pk, ev.z)
    pk.array(6)
    for s in ev.s:
        _pack_point_evals(pk, s)
    pk.array(15)
    for c in ev.coefficients:
        _pack_point_evals(pk, c)
    _pack_point_evals(pk, ev.generic_selector)
    _pack_point_evals(pk, ev.poseidon_selector)
    _pack_point_evals(pk, ev.complete_add_selector)
    _pack_point_evals(pk, ev.mul_selector)
    _pack_point_evals(pk, ev.emul_selector)
    _pack_point_evals(pk, ev.endomul_scalar_selector)
    for opt in [
        ev.range_check0_selector,
        ev.range_check1_selector,
        ev.foreign_field_add_selector,
        ev.foreign_field_mul_selector,
        ev.xor_selector,
        ev.rot_selector,
        ev.lookup_aggregation,
        ev.lookup_table,
    ]:
        _pack_opt_point_evals(pk, opt)
    pk.array(5)
    for opt in ev.lookup_sorted:
        _pack_opt_point_evals(pk, opt)
    for opt in [
        ev.runtime_lookup_table,
        ev.runtime_lookup_table_selector,
        ev.xor_lookup_selector,
        ev.lookup_gate_lookup_selector,
        ev.range_check_lookup_selector,
        ev.foreign_field_mul_lookup_selector,
    ]:
        _pack_opt_point_evals(pk, opt)

    pk.bin(field_bytes(proof.ft_eval1))

    pk.array(len(proof.prev_challenges))
    for rc in proof.prev_challenges:
        pk.array(2)
        pk.array(len(rc.chals))
        for c in rc.chals:
            pk.bin(field_bytes(c))
        _pack_poly_comm(pk, curve, rc.comm)

    return pk.getvalue()


def deserialize_proof(curve: CurveParams, data: bytes) -> ProverProof:
    up = Unpacker(data)
    assert up.array() == 5

    def poly_comm() -> PolyComm:
        assert up.array() == 1
        n = up.array()
        return PolyComm([point_from_bytes(curve, up.bin()) for _ in range(n)])

    def point_evals() -> PointEvaluations:
        assert up.array() == 2
        nz = up.array()
        z = [int.from_bytes(up.bin(), "little") for _ in range(nz)]
        nw = up.array()
        w = [int.from_bytes(up.bin(), "little") for _ in range(nw)]
        return PointEvaluations(z, w)

    def opt_point_evals():
        if up.peek_nil():
            return None
        return point_evals()

    assert up.array() == 4
    nw = up.array()
    w_comm = [poly_comm() for _ in range(nw)]
    z_comm = poly_comm()
    t_comm = poly_comm()
    lookup = None
    if not up.peek_nil():
        assert up.array() == 3
        ns = up.array()
        sorted_ = [poly_comm() for _ in range(ns)]
        aggreg = poly_comm()
        runtime = None if up.peek_nil() else poly_comm()
        lookup = LookupCommitments(sorted=sorted_, aggreg=aggreg, runtime=runtime)

    assert up.array() == 5
    nlr = up.array()
    lr = []
    for _ in range(nlr):
        assert up.array() == 2
        lr.append((point_from_bytes(curve, up.bin()), point_from_bytes(curve, up.bin())))
    delta = point_from_bytes(curve, up.bin())
    z1 = int.from_bytes(up.bin(), "little")
    z2 = int.from_bytes(up.bin(), "little")
    sg = point_from_bytes(curve, up.bin())
    opening = OpeningProof(lr=lr, delta=delta, z1=z1, z2=z2, sg=sg)

    assert up.array() == 26
    public = opt_point_evals()
    assert up.array() == 15
    w = [point_evals() for _ in range(15)]
    z = point_evals()
    assert up.array() == 6
    s = [point_evals() for _ in range(6)]
    assert up.array() == 15
    coefficients = [point_evals() for _ in range(15)]
    gen = point_evals()
    pos = point_evals()
    cadd = point_evals()
    mul = point_evals()
    emul = point_evals()
    endo_sc = point_evals()
    opts1 = [opt_point_evals() for _ in range(8)]
    assert up.array() == 5
    lookup_sorted = [opt_point_evals() for _ in range(5)]
    opts2 = [opt_point_evals() for _ in range(6)]

    evals = ProofEvaluations(
        public=public,
        w=w,
        z=z,
        s=s,
        coefficients=coefficients,
        generic_selector=gen,
        poseidon_selector=pos,
        complete_add_selector=cadd,
        mul_selector=mul,
        emul_selector=emul,
        endomul_scalar_selector=endo_sc,
        range_check0_selector=opts1[0],
        range_check1_selector=opts1[1],
        foreign_field_add_selector=opts1[2],
        foreign_field_mul_selector=opts1[3],
        xor_selector=opts1[4],
        rot_selector=opts1[5],
        lookup_aggregation=opts1[6],
        lookup_table=opts1[7],
        lookup_sorted=lookup_sorted,
        runtime_lookup_table=opts2[0],
        runtime_lookup_table_selector=opts2[1],
        xor_lookup_selector=opts2[2],
        lookup_gate_lookup_selector=opts2[3],
        range_check_lookup_selector=opts2[4],
        foreign_field_mul_lookup_selector=opts2[5],
    )

    ft_eval1 = int.from_bytes(up.bin(), "little")
    npc = up.array()
    prev = []
    for _ in range(npc):
        assert up.array() == 2
        nc = up.array()
        chals = [int.from_bytes(up.bin(), "little") for _ in range(nc)]
        prev.append(RecursionChallenge(chals=chals, comm=poly_comm()))

    return ProverProof(
        commitments=ProverCommitments(
            w_comm=w_comm, z_comm=z_comm, t_comm=t_comm, lookup=lookup
        ),
        proof=opening,
        evals=evals,
        ft_eval1=ft_eval1,
        prev_challenges=prev,
    )
