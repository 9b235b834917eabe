"""Proof and verifier-index wire formats: rmp-serde (MessagePack)
compatible layout.

Counterpart of proof_systems_tpu/serialization.py, host code copied as it
is: a proof or a verifier-index file written by either package reads in the
other.

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

from .circuits.gate import GateType
from .circuits.lookup import LookupInfo, LookupPattern
from .curves import AffinePoint, CurveParams, Pallas, Vesta
from .ops import ntt as ntt_mod
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
from .prover_index import build_linearization
from .verifier_index import LookupVerifierIndex, VerifierIndex

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


# ---------------------------------------------------------------------------
# VerifierIndex persistence (verifier_index.rs:345 to_file / :384 from_file).
# MessagePack layout mirroring the proof conventions above; the SRS and all
# derived structures (domain plan, zk polynomials, linearization AST, alpha
# registry) are reconstructed at load time, as the reference does.
# ---------------------------------------------------------------------------


def _pack_opt_poly_comm(pk: Packer, curve: CurveParams, c) -> None:
    if c is None:
        pk.nil()
    else:
        _pack_poly_comm(pk, curve, c)


def serialize_verifier_index(vk) -> bytes:
    curve = vk.curve
    pk = Packer()
    pk.array(12 if vk.lookup_index is None else 17)
    pk.bin(curve.name.encode())
    pk.uint(vk.domain.log_n)
    pk.uint(vk.max_poly_size)
    pk.uint(vk.zk_rows)
    pk.uint(vk.public)
    pk.array(len(vk.shift))
    for s in vk.shift:
        pk.bin(field_bytes(s))
    pk.array(7 + 15 + 6)
    for c in vk.sigma_comm:
        _pack_poly_comm(pk, curve, c)
    for c in vk.coefficients_comm:
        _pack_poly_comm(pk, curve, c)
    for c in [
        vk.generic_comm, vk.psm_comm, vk.complete_add_comm,
        vk.mul_comm, vk.emul_comm, vk.endomul_scalar_comm,
    ]:
        _pack_poly_comm(pk, curve, c)
    pk.array(6)
    for c in [
        vk.range_check0_comm, vk.range_check1_comm,
        vk.foreign_field_add_comm, vk.foreign_field_mul_comm,
        vk.xor_comm, vk.rot_comm,
    ]:
        _pack_opt_poly_comm(pk, curve, c)
    if vk.lookup_index is None:
        pk.array(0)
        pk.nil()
        pk.array(0)
        pk.nil()
        return pk.getvalue()
    li = vk.lookup_index
    pats = list(LookupPattern)
    pk.array(len(li.lookup_info.patterns) + (1 if li.joint_lookup_used else 0))
    if li.joint_lookup_used:
        pk.uint(1)
    for p in li.lookup_info.patterns:
        pk.uint(2 + pats.index(p))
    pk.bool(li.lookup_info.uses_runtime_tables)
    pk.array(len(li.lookup_table))
    for c in li.lookup_table:
        _pack_poly_comm(pk, curve, c)
    _pack_opt_poly_comm(pk, curve, li.table_ids)
    # selector comms in enum order, nil-padded; then runtime selector
    pk2 = [li.lookup_selectors.get(p) for p in pats] + [li.runtime_tables_selector]
    for c in pk2:
        _pack_opt_poly_comm(pk, curve, c)
    return pk.getvalue()


def deserialize_verifier_index(data: bytes, srs):
    """Rebuild a VerifierIndex against a live SRS (from_file semantics:
    verifier_index.rs:384; srs and derived members are not on disk). The
    domain's plan lives on the SRS's device."""
    up = Unpacker(data)
    n_fields = up.array()
    assert n_fields in (12, 17)
    curve_name = up.bin().decode()
    curve = {"Pallas": Pallas, "Vesta": Vesta}[curve_name]
    assert srs.curve is curve, "SRS curve mismatch"
    f = curve.scalar
    log_n = up.uint()
    max_poly_size = up.uint()
    zk_rows = up.uint()
    public = up.uint()
    shift = [int.from_bytes(up.bin(), "little") for _ in range(up.array())]

    def poly_comm() -> PolyComm:
        up.array()
        return PolyComm(
            [point_from_bytes(curve, up.bin()) for _ in range(up.array())]
        )

    def opt_poly_comm():
        if up.peek_nil():
            return None
        return poly_comm()

    ncomms = up.array()
    assert ncomms == 28
    comms = [poly_comm() for _ in range(28)]
    up.array()
    opt = [opt_poly_comm() for _ in range(6)]

    flags_raw = [up.uint() for _ in range(up.array())]
    pats = list(LookupPattern)
    joint_lookup_used = 1 in flags_raw
    patterns = [pats[v - 2] for v in flags_raw if v >= 2]
    uses_runtime = not up.peek_nil() and up.bool()
    ntables = up.array()
    lookup_vk = None
    lcs_shadow = None
    if ntables or patterns:
        table_comms = [poly_comm() for _ in range(ntables)]
        ids_comm = opt_poly_comm()
        sel_comms = {}
        for p in pats:
            c = opt_poly_comm()
            if c is not None:
                sel_comms[p] = c
        runtime_sel = opt_poly_comm()
        info = LookupInfo(
            patterns=patterns,
            max_per_row=max(p.max_lookups_per_row() for p in patterns),
            max_joint_size=max(p.max_joint_size() for p in patterns),
            joint_lookup_used=joint_lookup_used,
            uses_runtime_tables=uses_runtime,
        )
        lookup_vk = LookupVerifierIndex(
            joint_lookup_used=joint_lookup_used,
            lookup_info=info,
            lookup_table=table_comms,
            table_ids=ids_comm,
            lookup_selectors=sel_comms,
            runtime_tables_selector=runtime_sel,
        )

        class _ShadowLcs:
            pass

        lcs_shadow = _ShadowLcs()
        lcs_shadow.info = info
        lcs_shadow.table_ids = [] if ids_comm is not None else None
        lcs_shadow.runtime_selector_d1 = [] if runtime_sel is not None else None
    else:
        up.peek_nil()  # consume the nil table_ids slot

    domain = ntt_mod.ntt_plan(f, log_n, device=srs.device)
    n = domain.n
    gen = domain.group_gen
    p = f.p

    feature_flags = {
        g
        for g, c in zip(
            [
                GateType.RangeCheck0, GateType.RangeCheck1,
                GateType.ForeignFieldAdd, GateType.ForeignFieldMul,
                GateType.Xor16, GateType.Rot64,
            ],
            opt,
        )
        if c is not None
    }
    alphas, linearization = build_linearization(f, feature_flags, lcs_shadow)

    def eval_zkpm(x: int) -> int:
        term = pow(gen, n - zk_rows, p)
        acc = (x - term) % p
        acc = acc * (x - term * gen) % p
        acc = acc * (x - pow(gen, n - 1, p)) % p
        return acc

    # in-circuit endo = endo_q of the other curve (prover_index.rs:192)
    other = Pallas if curve.name == "Vesta" else Vesta
    return VerifierIndex(
        curve=curve,
        domain=domain,
        max_poly_size=max_poly_size,
        zk_rows=zk_rows,
        public=public,
        sigma_comm=comms[:7],
        coefficients_comm=comms[7:22],
        generic_comm=comms[22],
        psm_comm=comms[23],
        complete_add_comm=comms[24],
        mul_comm=comms[25],
        emul_comm=comms[26],
        endomul_scalar_comm=comms[27],
        shift=shift,
        endo=other.endos[0],
        zkpm_eval=eval_zkpm,
        srs=srs,
        linearization_expr=linearization,
        alphas=alphas,
        zk_w=pow(gen, n - zk_rows, p),
        range_check0_comm=opt[0],
        range_check1_comm=opt[1],
        foreign_field_add_comm=opt[2],
        foreign_field_mul_comm=opt[3],
        xor_comm=opt[4],
        rot_comm=opt[5],
        lookup_index=lookup_vk,
    )


# ---------------------------------------------------------------------------
# o1vm column proofs
# ---------------------------------------------------------------------------


def serialize_column_proof(curve: CurveParams, fields: dict) -> bytes:
    """An o1vm ColumnProof, given as convert.column_proof_fields (of either
    package), in the primitives above: a MessagePack array of the
    commitments (an array, each commitment one bin of its 33-byte
    compressed chunks), the zeta and zeta*omega evaluations (one bin each
    of 32-byte LE elements), the quotient commitment (one bin of its
    chunks), its zeta and zeta*omega chunk evaluations (one bin each), and
    the opening [lr (an array of 66-byte bins), delta, z1, z2, sg]."""

    def points(pts) -> bytes:
        return b"".join(point_bytes(curve, pt) for pt in pts)

    def elems(xs) -> bytes:
        return b"".join(field_bytes(int(x)) for x in xs)

    pk = Packer()
    pk.array(7)
    pk.array(len(fields["commitments"]))
    for chunks in fields["commitments"]:
        pk.bin(points(chunks))
    pk.bin(elems(fields["zeta_evaluations"]))
    pk.bin(elems(fields["zeta_omega_evaluations"]))
    pk.bin(points(fields["quotient_commitment"]))
    for ev in fields["quotient_evaluations"]:
        pk.bin(elems(ev))
    op = fields["opening"]
    pk.array(5)
    pk.array(len(op["lr"]))
    for lr in op["lr"]:
        pk.bin(points(lr))
    pk.bin(points([op["delta"]]))
    pk.bin(field_bytes(op["z1"]))
    pk.bin(field_bytes(op["z2"]))
    pk.bin(points([op["sg"]]))
    return pk.getvalue()


def deserialize_column_proof(curve: CurveParams, data: bytes) -> dict:
    """serialize_column_proof's bytes -> the fields of
    convert.column_proof_fields (column_proof_from_fields makes the proof)."""
    up = Unpacker(data)
    if up.array() != 7:
        raise ValueError("not a column proof")

    def points() -> list:
        raw = up.bin()
        return [point_from_bytes(curve, raw[i : i + 33]) for i in range(0, len(raw), 33)]

    def elems() -> list[int]:
        raw = up.bin()
        return [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]

    commitments = [points() for _ in range(up.array())]
    zeta, zeta_omega = elems(), elems()
    quotient = points()
    q_evals = (elems(), elems())
    if up.array() != 5:
        raise ValueError("not a column proof's opening")
    lr = [tuple(points()) for _ in range(up.array())]
    delta = points()[0]
    z1, z2 = (int.from_bytes(up.bin(), "little") for _ in range(2))
    sg = points()[0]
    if up.pos != len(data):
        raise ValueError(f"{len(data) - up.pos} bytes after the column proof")
    return dict(commitments=commitments, zeta_evaluations=zeta, zeta_omega_evaluations=zeta_omega,
                quotient_commitment=quotient, quotient_evaluations=q_evals,
                opening=dict(lr=lr, delta=delta, z1=z1, z2=z2, sg=sg))
