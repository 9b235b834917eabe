"""K6 (ec_prefix_scan_parts) on the CPU. The CUDA kernel (k_ec_parts in
csrc/curve_kernels.cu) may split each lane chunk of cp positions over a
team of S threads: each reduces its sub-chunk of sc = ceil(cp / S), the
team takes an exclusive scan of the S totals, each rescans its sub-chunk
from its offset. That association order is modelled here with the plain
curve formulas and held, as group elements, against the host curve's
running sums, for every team size and both variants, on rows with
identities at a sub-chunk boundary and filling a lane, and P then P and P
then -P across a boundary (the doubling and negation fallbacks). At S = 1
the model is the plain version limb for limb. Also the geometry the wrapper
derives (kernels.parts_geometry). The kernel itself: tests/test_torch_cuda.py."""

import random

import pytest
import torch

from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.ops import kernels
from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve

torch.set_num_threads(1)

NL, LANES = kernels.NL, kernels.LANES


def team_model(F, x, y, z, mixed: bool, S: int):
    """k_ec_parts' values on (8, rows, n) rows with S threads a lane chunk,
    then k_ec_lane_offsets: (partial, excl, cp) as the wrapper returns them.
    Positions outside [0, n) and a member's empty slots hold the identity,
    and identity + v and v + identity are v exactly in the complete
    formulas, so no masks are needed."""
    rows, n = x.shape[1], x.shape[2]
    P = kernels.field16(F, x.device)
    step = kernels.ec_madd16 if mixed else kernels.ec_add16
    cp = kernels.scan_chunk(n)
    sc = -(-cp // S)
    lane = torch.arange(LANES)[:, None, None]
    member = torch.arange(S)[None, :, None]
    k = torch.arange(sc)[None, None, :]
    off = member * sc + k  # position inside the lane chunk
    pos = (lane * cp + off).expand(LANES, S, sc)
    inside = (off < cp).expand(LANES, S, sc)
    src = torch.where(inside & (pos < n), pos, n).reshape(-1)
    ins = tuple(
        torch.cat([kernels.to16(t), torch.zeros((16, rows, 1), dtype=torch.int64)], -1)[..., src]
        .reshape(16, rows, LANES, S, sc)
        for t in (x, y, z)
    )
    ident = torch.zeros((16, rows, LANES, S), dtype=torch.int64)
    tot = (ident,) * 3
    for i in range(sc):  # (a) reduce
        tot = step(P, tot, tuple(t[..., i] for t in ins))

    def shift(t, d):  # along the team axis, the identity shifted in
        return torch.cat([ident[..., :d], t[..., : S - d]], dim=-1)

    incl, d = tot, 1
    while d < S:  # (b) exclusive team scan, general adds
        incl = kernels.ec_add16(P, tuple(shift(t, d) for t in incl), incl)
        d *= 2
    carry = tuple(shift(t, 1) for t in incl)
    parts = [torch.zeros((16, rows, LANES * cp), dtype=torch.int64) for _ in range(3)]
    for i in range(sc):  # (c) rescan, every position of the lane written
        carry = step(P, carry, tuple(t[..., i] for t in ins))
        at = pos[..., i][inside[..., i]]
        for dst, c in zip(parts, carry):
            dst[..., at] = c[..., inside[..., i]]
    zero = torch.zeros((16, 1, 1), dtype=torch.int64)
    excl = tuple(kernels._shift_lanes(t[..., S - 1], 1, zero) for t in carry)
    s = 1
    while s < LANES:  # the lane offsets, as k_ec_lane_offsets
        excl = kernels.ec_add16(P, excl, tuple(kernels._shift_lanes(t, s, zero) for t in excl))
        s *= 2
    return tuple(map(kernels.from16, parts)), tuple(map(kernels.from16, excl)), cp


def structured_rows(rng, rows: int, n: int):
    """Host points, row-major, cp = 8 at n = 1000: in lane 3 only P, P at
    positions 3 and 4 of the chunk, in lane 5 only P, -P there, in lane 6
    only P, P at 1 and 2 (each pair straddles the sub-chunk boundaries of
    sc = 4, 2, 1 or 2, 1), lane 7 all identities, identities at 3 and 4 of
    lane 9; random points elsewhere."""
    pool = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator)
            for _ in range(32)]
    pts = [rng.choice(pool) for _ in range(rows * n)]
    cp = kernels.scan_chunk(n)
    for r in range(rows):
        base = r * n

        def lane_only(L, pairs):
            for j in range(L * cp, min(L * cp + cp, n)):
                pts[base + j] = None
            for j, pt in pairs:
                if j < cp and L * cp + j < n:
                    pts[base + L * cp + j] = pt

        P = pool[r]
        lane_only(3, [(3, P), (4, P)])
        lane_only(5, [(3, P), (4, Vesta.neg(P))])
        lane_only(6, [(1, P), (2, P)])
        lane_only(7, [])
        for j in (3, 4):
            if j < cp and 9 * cp + j < n:
                pts[base + 9 * cp + j] = None
    return pts


def host_prefix(pts, rows: int, n: int):
    out = []
    for r in range(rows):
        acc = None
        for pt in pts[r * n:(r + 1) * n]:
            acc = Vesta.add(acc, pt)
            out.append(acc)
    return out


def reconstruct(dc, partial, excl, cp, rows: int, n: int):
    """excl[j // cp] + partial[j] for j < n, as host affine points."""
    j = torch.arange(n)
    pref = dc.add(
        JPoint(*(torch.gather(t, -1, (j // cp).expand(NL, rows, n)) for t in excl)),
        JPoint(*(t[..., :n] for t in partial)),
    )
    return dc.unpack_jacobian(JPoint(*(t.reshape(NL, rows * n) for t in pref)))


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "general"])
@pytest.mark.parametrize("n,S", [(1000, 1), (1000, 2), (1000, 4), (1000, 8), (1000, 16),
                                 (300, 4), (100, 2), (1, 2)])
def test_team_split_gives_the_prefix_sums(n, S, mixed):
    rng = random.Random(700 + n + S)
    rows = 2
    dc = device_curve(Vesta)
    pts = structured_rows(rng, rows, n)
    J = dc.to_jacobian(dc.pack_affine(pts, device="cpu"))
    if not mixed:  # a general Jacobian input: z != R
        J = dc.double(J)
        pts = [Vesta.double(p) for p in pts]
    J = JPoint(*(t.reshape(NL, rows, n) for t in J))
    partial, excl, cp = team_model(dc.F, *J, mixed, S)
    assert cp == kernels.scan_chunk(n)
    assert partial[0].shape == (NL, rows, LANES * cp) and excl[0].shape == (NL, rows, LANES)
    assert reconstruct(dc, partial, excl, cp, rows, n) == host_prefix(pts, rows, n)
    if S == 1:  # one thread a chunk: the plain version's association order
        want_p, want_e, _ = kernels.ec_prefix_scan_parts_plain(dc.F, *J, mixed=mixed)
        for a, b in zip(partial + excl, want_p + want_e):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rows,cp,sms", [(360, 513, 132), (168, 513, 132), (24, 513, 132),
                                         (24, 514, 132), (360, 16, 132), (24, 16, 132),
                                         (48, 257, 132), (2, 66, 132), (1, 3, 132),
                                         (1, 1, 132), (672, 513, 132), (24, 513, 16)])
def test_parts_geometry(rows, cp, sms):
    """S is a power of two up to 16 that keeps at least 8 positions a
    thread and one pass of threads; one thread a chunk once the rows fill a
    quarter of the card (the commits of 15 and 7 columns, 360 and 168 rows);
    a team for the 24 rows of the z commit and the verifier; KT = 16 for
    one thread a chunk of 64 positions or more."""
    S, kt = kernels.parts_geometry(rows, cp, sms)
    lanes, slots = rows * LANES, sms * kernels.PARTS_SM_THREADS
    assert S & (S - 1) == 0 and 1 <= S <= kernels.PARTS_TEAM_MAX
    assert S == 1 or (cp >= 8 * S and lanes * S <= slots and 4 * lanes < slots)
    assert kt == (16 if S == 1 and cp >= 64 else 4)
    if 4 * lanes >= slots:
        assert S == 1
    expect = {(360, 513, 132): (1, 16), (168, 513, 132): (1, 16), (24, 513, 132): (16, 4),
              (360, 16, 132): (1, 4)}
    if (rows, cp, sms) in expect:
        assert (S, kt) == expect[(rows, cp, sms)]
