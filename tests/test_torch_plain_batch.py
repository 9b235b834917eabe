"""chip_smoke.py's joined plain checks on the CPU: the plain versions of
calls that share a batch key (chip_smoke.batch_key), computed as one plain
call and split back (plain_outputs), equal each call's own plain version
limb for limb, for every kernel that joins: K4 over flattened elements, the
ladder and K11 with a challenge a call, K8 over columns of other window
widths and counts, and K6, K7, K12, K5 and K9 over rows; calls with another
key stay apart."""

import random

import pytest
import torch

import chip_smoke
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.ops import kernels, limb
from proof_systems_tpu_torch.ops.curve_ops import device_curve

# One intra-op thread: the suite runs a test process per core, and torch's
# default of one thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

CPU = torch.device("cpu")


def points(curve, k, seed, with_infinity=True):
    rng = random.Random(seed)
    pts = [curve.scalar_mul(rng.randrange(1, curve.scalar.p), curve.generator) for _ in range(k)]
    if with_infinity:
        pts[1] = None
    dc = device_curve(curve)
    return dc, dc.to_jacobian(dc.pack_affine(pts, device=CPU))


def bits(seed):
    rng = random.Random(seed)
    return torch.tensor([rng.randrange(2) for _ in range(128)], dtype=torch.int32)


def field_rows(F, shape, seed):
    rng = random.Random(seed)
    n = 1
    for d in shape:
        n *= d
    return F.pack_mont([rng.randrange(F.p) for _ in range(n)], shape=shape, device=CPU)


def cases():
    F, Fb = limb.device_field(Fp), limb.device_field(Fq)
    dc, P = points(Vesta, 12, 1)
    dcq, Q = points(Pallas, 6, 2)
    wins = [t[:, :12].reshape(8, 3, 4).contiguous() for t in dc.double(P)]
    wins2 = [t[:, :6].reshape(8, 3, 2).contiguous() for t in P]
    wins3 = [t[:, 6:10].reshape(8, 2, 2).contiguous() for t in dc.double(P)]
    return {
        "mont_pow": [[F, field_rows(F, (3,), 3), Fp.p - 2], [F, field_rows(F, (2, 5), 4), Fp.p - 2],
                     [F, field_rows(F, (1,), 5), 21], [Fb, field_rows(Fb, (4,), 6), Fq.p - 2]],
        "endo_ladder": [[dc.F, Vesta.endos[0], *(t[:, :5].contiguous() for t in P), bits(7)],
                        [dc.F, Vesta.endos[0], *(t[:, 5:].contiguous() for t in P), bits(8)],
                        [dcq.F, Pallas.endos[0], *Q, bits(9)]],
        "endo_inv": [[F, Vesta.endos[1], bits(10)], [F, Vesta.endos[1], bits(11)],
                     [Fb, Pallas.endos[1], bits(12)]],
        "combine_windows": [[dc.F, 3, *wins], [dc.F, 3, *wins2], [dc.F, 2, *wins2],
                            [dc.F, 4, *wins3]],
        "ec_prefix_scan_parts": [
            [dc.F, *(t[:, :12].reshape(8, 1, 2, 6).contiguous() for t in P)],
            [dc.F, *(t[:, :6].reshape(8, 1, 6).contiguous() for t in P)],
            [dc.F, *(t[:, :10].reshape(8, 2, 5).contiguous() for t in P)]],
        "ec_prefix_scan_fused": [[dc.F, *(t[:, :12].reshape(8, 2, 6).contiguous() for t in P)],
                                 [dc.F, *(t[:, 6:12].reshape(8, 1, 6).contiguous() for t in P)]],
        "mont_prefix_scan_parts": [[F, field_rows(F, (2, 300), 13)], [F, field_rows(F, (300,), 14)]],
        "mont_prefix_scan": [[F, field_rows(F, (2, 33), 15)], [F, field_rows(F, (1, 33), 16)],
                             [F, field_rows(F, (1, 32), 17)]],
        "linear_scan": [[F, field_rows(F, (2, 140), 18), 5], [F, field_rows(F, (140,), 19), 5],
                        [F, field_rows(F, (140,), 20), 7]],
    }


def same(got, want) -> bool:
    if torch.is_tensor(want):
        return got.shape == want.shape and torch.equal(got, want)
    if isinstance(want, tuple):
        return len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))
    return got == want


@pytest.mark.parametrize("name", sorted(cases()))
def test_joined_plain_calls_equal_each_plain_call(name):
    kw = {"mixed": True} if name == "ec_prefix_scan_parts" else {}
    calls = [(name, args, kw) for args in cases()[name]]
    keys = [chip_smoke.batch_key(name, args, kw) for _, args, kw in calls]
    ref = getattr(kernels, name + "_plain")
    seen = []
    for i, got, _, joined in chip_smoke.plain_outputs(kernels, calls, CPU):
        _, args, kw = calls[i]
        assert joined == keys.count(keys[i])
        assert same(got, ref(*args, **kw))
        seen.append((i, joined))
    assert sorted(i for i, _ in seen) == list(range(len(calls)))
    assert max(j for _, j in seen) > 1  # some calls were joined


def test_elementwise_plain_calls_on_slices(monkeypatch):
    """chip_smoke.plain_call runs K1's and K4's plain versions on slices of
    at most PLAIN_WIDTH elements: the same limbs as one call."""
    monkeypatch.setattr(chip_smoke, "PLAIN_WIDTH", 7)
    F = limb.device_field(Fp)
    a, b = field_rows(F, (3, 10), 30), field_rows(F, (3, 10), 31)
    for name, args in (("mont_mul", [F, a, b]), ("mont_pow", [F, a, Fp.p - 2])):
        ref = getattr(kernels, name + "_plain")
        assert torch.equal(chip_smoke.plain_call(ref, name, args, {}), ref(*args))
