"""Keccak-f[1600] + keccak256, with execution-proof columns, on the card.

Counterpart of proof_systems_tpu/o1vm/keccak.py. The host code (the
permutation, the hashes, the witness columns and the constraint AST) is the
JAX package's, copied as it is; the class-batched quotient numerator is
written here on the port's limb layout, and the proof runs through
o1vm/pickles.prove_columns on the device the caller names (the card unless
device="cpu").

Capability mirror of o1vm/src/interpreters/keccak/ (dual-mode Keccak
interpreter: witness columns + constraints) and the kimchi Keccak
gadget circuits (kimchi/src/circuits/polynomials/keccak/).

Instead of the reference's 13/15-bit sparse-limb representation (tuned for
CPU u64 tricks + plookup), the state is BIT-SLICED: one boolean column per
state bit, one row per round. Bitwise logic becomes low-degree field
algebra over columns —
  xor(a,b)   = a + b - 2ab
  chi(b0,b1,b2) = b0 + (1-b1) b2 - 2 b0 (1-b1) b2
and the 5-way theta parity uses a carry trick: witness the parity bit
plus two carry bits (k0, k1) with  sum5 = parity + 2 k0 + 4 k1.
All constraints are degree <= 3; booleanity pins every column. The
lookup tables of the sparse encoding are not needed.

Row layout (one row per round, NEXT row = post-round state):
  state bits a[x][y][z]        5*5*64 = 1600 columns
  theta parity[x][z]                    320 columns
  theta carries k0[x][z], k1[x][z]      640 columns
  post-theta bits t[x][y][z]           1600 columns   (total 4160)
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuits import expr as E
from ..fields import FieldParams
from ..ops import limb
from ..runtime import resolve_device

ROUNDS = 24
RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rho rotation offsets r[x][y]
RHO = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
MASK64 = (1 << 64) - 1


def _rotl(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & MASK64


def keccak_f(state: list[list[int]]) -> list[list[int]]:
    """The permutation on a 5x5 matrix of 64-bit lanes (host golden)."""
    a = [row[:] for row in state]
    for rnd in range(ROUNDS):
        a = keccak_round(a, RC[rnd])
    return a


def keccak_round(a: list[list[int]], rc: int) -> list[list[int]]:
    c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
    d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
    t = [[(a[x][y] ^ d[x]) for y in range(5)] for x in range(5)]
    b = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            b[y][(2 * x + 3 * y) % 5] = _rotl(t[x][y], RHO[x][y])
    out = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            out[x][y] = b[x][y] ^ ((b[(x + 1) % 5][y] ^ MASK64) & b[(x + 2) % 5][y])
    out[0][0] ^= rc
    return out


def keccak256(data: bytes) -> bytes:
    """Ethereum-style Keccak-256 (pad 0x01, rate 1088)."""
    return _sponge(data, rate_bytes=136, out_bytes=32, pad_byte=0x01)


def sha3_256(data: bytes) -> bytes:
    """NIST SHA3-256 (pad 0x06)."""
    return _sponge(data, rate_bytes=136, out_bytes=32, pad_byte=0x06)


def _sponge(data: bytes, rate_bytes: int, out_bytes: int, pad_byte: int) -> bytes:
    state = [[0] * 5 for _ in range(5)]
    msg = bytearray(data)
    msg.append(pad_byte)
    while len(msg) % rate_bytes:
        msg.append(0)
    msg[-1] |= 0x80
    for off in range(0, len(msg), rate_bytes):
        block = msg[off : off + rate_bytes]
        for i in range(rate_bytes // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        state = keccak_f(state)
    out = bytearray()
    while len(out) < out_bytes:
        for i in range(rate_bytes // 8):
            x, y = i % 5, i // 5
            out += state[x][y].to_bytes(8, "little")
            if len(out) >= out_bytes:
                break
        if len(out) < out_bytes:
            state = keccak_f(state)
    return bytes(out[:out_bytes])


# -- execution-proof columns ------------------------------------------------


class Layout:
    def __init__(self):
        idx = 0

        def block(n):
            nonlocal idx
            r = list(range(idx, idx + n))
            idx += n
            return r

        self.a = block(1600)  # bit (x*5 + y)*64 + z
        self.parity = block(320)  # x*64 + z
        self.k0 = block(320)
        self.k1 = block(320)
        self.t = block(1600)  # post-theta bits
        self.ncols = idx

    def abit(self, x, y, z):
        return self.a[(x * 5 + y) * 64 + z]

    def tbit(self, x, y, z):
        return self.t[(x * 5 + y) * 64 + z]


LAYOUT = Layout()


def build_columns(f: FieldParams, state0: list[list[int]], nrows: int | None = None):
    """Witness for one full permutation: ROUNDS rows + 1 output row."""
    L = LAYOUT
    n = nrows or (ROUNDS + 1)
    assert n >= ROUNDS + 1
    cols = [[0] * n for _ in range(L.ncols)]
    a = [row[:] for row in state0]
    for rnd in range(ROUNDS):
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lane = a[x][y]
                tlane = lane ^ d[x]
                for z in range(64):
                    cols[L.abit(x, y, z)][rnd] = (lane >> z) & 1
                    cols[L.tbit(x, y, z)][rnd] = (tlane >> z) & 1
        for x in range(5):
            for z in range(64):
                s = sum((a[x][y] >> z) & 1 for y in range(5))
                cols[L.parity[x * 64 + z]][rnd] = s & 1
                cols[L.k0[x * 64 + z]][rnd] = (s >> 1) & 1
                cols[L.k1[x * 64 + z]][rnd] = (s >> 2) & 1
        a = keccak_round(a, RC[rnd])
    for x in range(5):
        for y in range(5):
            for z in range(64):
                cols[L.abit(x, y, z)][ROUNDS] = (a[x][y] >> z) & 1
    return cols, a


def _xor(a: E.Expr, b: E.Expr) -> E.Expr:
    return a + b - E.Literal(2) * a * b


def round_selector_column(f: FieldParams, n: int) -> list[int]:
    """1 on the ROUNDS active rows, 0 after (gates the transition)."""
    return [1 if i < ROUNDS else 0 for i in range(n)]


def constraints(f: FieldParams, sel_col: int, rc_cols: list[int]) -> list[E.Expr]:
    """Round-function constraints, gated by a selector column and fed the
    per-row round-constant bits from 64 fixed columns `rc_cols`.

    Degree <= 3 + selector: theta parity is linear given the carry bits;
    chi/iota read the witnessed post-theta bits through the rho/pi
    permutation (an index shuffle — free)."""
    from .pickles import col

    L = LAYOUT

    def c(i, row=E.CURR):
        return E.Cell(col(i), row)

    sel = c(sel_col)
    one = E.Literal(1)
    out = []

    # booleanity (ungated: all columns are bits everywhere)
    for i in [*L.a, *L.parity, *L.k0, *L.k1, *L.t]:
        out.append(c(i).boolean())

    # theta parity with carry bits: sum_y a - parity - 2 k0 - 4 k1 = 0
    for x in range(5):
        for z in range(64):
            s: E.Expr = E.Literal(0)
            for y in range(5):
                s = s + c(L.abit(x, y, z))
            i = x * 64 + z
            out.append(
                sel
                * (s - c(L.parity[i]) - E.Literal(2) * c(L.k0[i]) - E.Literal(4) * c(L.k1[i]))
            )

    # post-theta bits: t = a xor d, d[x][z] = parity[x-1][z] xor parity[x+1][z-1]
    for x in range(5):
        for z in range(64):
            d = _xor(
                c(L.parity[((x - 1) % 5) * 64 + z]),
                c(L.parity[((x + 1) % 5) * 64 + ((z - 1) % 64)]),
            )
            for y in range(5):
                out.append(sel * (c(L.tbit(x, y, z)) - _xor(c(L.abit(x, y, z)), d)))

    # chi + iota on rho/pi-shuffled post-theta bits -> next-row state
    # b[y][(2x+3y)%5][z] = t[x][y][(z - RHO[x][y]) % 64]
    def bbit(x, y, z):
        for sx in range(5):
            for sy in range(5):
                if (sy, (2 * sx + 3 * sy) % 5) == (x, y):
                    return c(L.tbit(sx, sy, (z - RHO[sx][sy]) % 64))
        raise AssertionError

    for x in range(5):
        for y in range(5):
            for z in range(64):
                b0 = bbit(x, y, z)
                b1 = bbit((x + 1) % 5, y, z)
                b2 = bbit((x + 2) % 5, y, z)
                chi = b0 + (one - b1) * b2 - E.Literal(2) * b0 * (one - b1) * b2
                nxt = c(L.abit(x, y, z), E.NEXT)
                if x == 0 and y == 0:
                    chi = _xor(chi, c(rc_cols[z]))
                out.append(sel * (nxt - chi))
    return out


# -- proving (pickles column prover, class-batched quotient) -----------------
#
# The permutation trace has 4,160 bit columns and 7,680 + 3,200 tiny
# constraints. The generic AST walk (expr.eval_dev) would launch a few ops
# for every node of every one; instead each CLASS of same-shape constraints
# is one stacked (8, K, 8n) limb tensor, and the classes are folded with
# their alpha powers — the same numerator sum alpha^i c_i. The verifier
# recomputes the AST at zeta (scalar, cheap), so the powers must follow the
# constraint ORDER exactly: booleanity, theta parity, post-theta bits,
# chi/iota, then the row-0 / row-ROUNDS state pins.


def _perm_index_maps():
    """Flat t-column offsets for b(x,y,z), b(x+1,y,z), b(x+2,y,z) in
    chi's x->y->z constraint order."""
    src = {}
    for sx in range(5):
        for sy in range(5):
            src[(sy, (2 * sx + 3 * sy) % 5)] = (sx, sy)
    maps = []
    for dx in range(3):
        idx = np.empty(1600, dtype=np.int32)
        k = 0
        for x in range(5):
            for y in range(5):
                sx, sy = src[((x + dx) % 5, y)]
                for z in range(64):
                    idx[k] = (sx * 5 + sy) * 64 + ((z - RHO[sx][sy]) % 64)
                    k += 1
        maps.append(idx)
    return maps


def state_pin_constraints(f: FieldParams, state0, final, rounds_row: int):
    """Boundary pins: row 0 holds state0's bits, row `rounds_row` the
    output bits (appended after constraints() in alpha order)."""
    from .pickles import col

    L = LAYOUT
    out = []
    for row, st in ((0, state0), (rounds_row, final)):
        lag = E.UnnormalizedLagrangeBasis(row)
        for x in range(5):
            for y in range(5):
                for z in range(64):
                    bit = (st[x][y] >> z) & 1
                    out.append(lag * (E.Cell(col(L.abit(x, y, z)), E.CURR)
                                      - E.Literal(bit)))
    return out




def _alpha_powers(F, alpha: int, count: int, device) -> tuple[list[int], torch.Tensor]:
    """alpha^0 .. alpha^(count-1): the ints, and (8, count, 1) Montgomery."""
    p = F.p
    pows = [1] * count
    for i in range(1, count):
        pows[i] = pows[i - 1] * alpha % p
    return pows, F.pack_mont(pows, shape=(count, 1), device=device)


def _sum_classes(F, v: torch.Tensor) -> torch.Tensor:
    """(8, K, m) -> (8, m): the sum over K, halving K at each step."""
    while v.shape[1] > 1:
        if v.shape[1] % 2:
            v = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
        half = v.shape[1] // 2
        v = limb.add(F, v[:, :half], v[:, half:])
    return v[:, 0]


def batched_numerator(f: FieldParams, sel_idx: int, rc_idx, state0, final):
    """-> callable(evals8, ctx) computing the combined quotient numerator
    over d8 ((8, C, 8n) Montgomery evaluations in, (8, 8n) out) from one
    stacked tensor per constraint class and its alpha powers: the gated
    classes' weighted sum times the selector once, the state pins as
    lag_row * (sum_i alpha^i a_i - sum_i alpha^i bit_i)."""
    L = LAYOUT
    maps = [torch.from_numpy(m.astype(np.int64)) for m in _perm_index_maps()]
    nclass = L.ncols + 320 + 1600 + 1600  # booleanity, parity, post-theta, chi

    def run(evals8, ctx):
        F = ctx.F
        dev = evals8.device
        n8 = evals8.shape[-1]
        NL = limb.NLIMBS
        add, sub, mul = (lambda a, b: limb.add(F, a, b)), (lambda a, b: limb.sub(F, a, b)), (
            lambda a, b: limb.mont_mul(F, a, b))
        pows, apow = _alpha_powers(F, ctx.challenges["alpha"], nclass + 2 * 1600, dev)

        # A: booleanity x^2 - x of every bit column
        x = evals8[:, : L.ncols]
        A = sub(limb.mont_sqr(F, x), x)

        # B: theta parity (x -> z): sum_y a - parity - 2 k0 - 4 k1
        a5 = evals8[:, :1600].reshape(NL, 5, 5, 64, n8)
        par, k0, k1 = (evals8[:, blk[0] : blk[0] + 320].reshape(NL, 5, 64, n8)
                       for blk in (L.parity, L.k0, L.k1))
        s = add(add(add(a5[:, :, 0], a5[:, :, 1]), add(a5[:, :, 2], a5[:, :, 3])), a5[:, :, 4])
        k1x2 = add(k1, k1)
        B = sub(sub(sub(s, par), add(k0, k0)), add(k1x2, k1x2)).reshape(NL, 320, n8)

        # C: post-theta bits (x -> z -> y): t - a - d + 2ad with
        #    d = p1 + p2 - 2 p1 p2, p1 = parity[x-1][z], p2 = parity[x+1][z-1]
        p1 = torch.roll(par, 1, dims=1)
        p2 = torch.roll(par, shifts=(-1, 1), dims=(1, 2))
        p12 = mul(p1, p2)
        d = sub(add(p1, p2), add(p12, p12))
        a_xzy = a5.permute(0, 1, 3, 2, 4)
        t_xzy = evals8[:, L.t[0] : L.t[0] + 1600].reshape(NL, 5, 5, 64, n8).permute(0, 1, 3, 2, 4)
        d_b = d[:, :, :, None].expand_as(a_xzy)
        ad = mul(a_xzy, d_b)
        C = add(sub(sub(t_xzy, a_xzy), d_b), add(ad, ad)).reshape(NL, 1600, n8)

        # D: chi/iota (x -> y -> z): a_next - chi, the round constant xored
        #    into lane (0, 0), the first 64 entries (xor with 0 elsewhere is
        #    the identity)
        t_flat = evals8[:, L.t[0] : L.t[0] + 1600]
        b0, b1, b2 = (t_flat[:, m.to(dev)] for m in maps)
        u = mul(sub(F.one_mont((1600, n8), device=dev), b1), b2)
        b0u = mul(b0, u)
        chi = add(b0, sub(u, add(b0u, b0u)))
        rc = evals8[:, rc_idx[0] : rc_idx[0] + 64]
        crc = mul(chi[:, :64], rc)
        chi = torch.cat([add(chi[:, :64], sub(rc, add(crc, crc))), chi[:, 64:]], dim=1)
        D = sub(torch.roll(evals8[:, :1600], -8, dims=-1), chi)  # NEXT row: 8 d8 points on

        # sum_i alpha^i sel c_i = sel * sum_i alpha^i c_i over the gated classes
        gated = _sum_classes(F, mul(torch.cat([B, C, D], dim=1), apow[:, L.ncols : nclass]))
        total = add(_sum_classes(F, mul(A, apow[:, : L.ncols])), mul(gated, evals8[:, sel_idx]))

        # E: state pins at rows 0 and ROUNDS
        start = nclass
        for row, st in ((0, state0), (ROUNDS, final)):
            wsum = _sum_classes(F, mul(evals8[:, :1600], apow[:, start : start + 1600]))
            bits = [(st[x][y] >> z) & 1 for x in range(5) for y in range(5) for z in range(64)]
            litsum = sum(w for w, bit in zip(pows[start : start + 1600], bits) if bit) % F.p
            pin = sub(wsum, F.const_mont(litsum, (n8,), device=dev))
            total = add(total, mul(pin, ctx.unnormalized_lagrange[row]))
            start += 1600
        return total

    return run


def _fixed_columns(f: FieldParams, n: int) -> list[list[int]]:
    """The round selector and the 64 round-constant bit columns, appended
    after the 4,160 bit columns (the verifier pins them by recommitment)."""
    cols = [round_selector_column(f, n)]
    for z in range(64):
        cols.append([(RC[r] >> z) & 1 if r < ROUNDS else 0 for r in range(n)])
    return cols


def _statement_constraints(f: FieldParams, state0, final):
    sel_idx = LAYOUT.ncols
    rc_idx = [LAYOUT.ncols + 1 + z for z in range(64)]
    cons = constraints(f, sel_idx, rc_idx) + state_pin_constraints(f, state0, final, ROUNDS)
    return sel_idx, rc_idx, cons


def prove_keccak(domain, srs, curve, state0, rng, device=None):
    """Prove one keccak-f permutation: ROUNDS+1 rows, all 4,160 bit
    columns + selector + 64 round-constant columns (pinned by the
    verifier via recommitment), on `device` (the card unless the caller
    passes device="cpu"), where `domain` and `srs` live too. Returns
    (proof, final_state)."""
    from .pickles import prove_columns

    dev = resolve_device(device)
    f = curve.scalar
    n = domain.d1.n
    if n < ROUNDS + 1:
        raise ValueError(f"a domain of {n} rows cannot hold {ROUNDS + 1}")
    cols, final = build_columns(f, state0, n)
    cols.extend(_fixed_columns(f, n))
    sel_idx, rc_idx, cons = _statement_constraints(f, state0, final)
    F = limb.device_field(f)
    packed = F.pack_mont([v for colv in cols for v in colv], shape=(len(cols), n), device=dev)
    proof = prove_columns(
        domain, srs, curve, packed, cons, rng,
        quotient_numerator=batched_numerator(f, sel_idx, rc_idx, state0, final), device=dev,
    )
    return proof, final


def verify_keccak(domain, srs, curve, proof, state0, final, rng, device=None) -> bool:
    """Check a keccak-f proof against the public (state0 -> final)
    statement: rebuild the constraint AST (incl. boundary pins), pin the
    selector and round-constant columns by recommitting them (one commit
    of the 65 columns), verify. On `device`, the SRS's (the card unless
    the caller passes device="cpu")."""
    from .pickles import pinned_columns_match, verify_columns

    dev = resolve_device(device)
    if torch.device(srs.device).type != dev.type:
        raise ValueError(f"the SRS is on {srs.device}, expected {dev}")
    f = curve.scalar
    sel_idx, _, cons = _statement_constraints(f, state0, final)
    fixed = _fixed_columns(f, domain.d1.n)
    pinned = {sel_idx + i: colv for i, colv in enumerate(fixed)}
    if not pinned_columns_match(domain, srs, proof, pinned, dev):
        return False
    return verify_columns(domain, srs, curve, cons, proof, rng)
