"""The port's field layer (proof_systems_tpu_torch.ops.limb) against the JAX
package's ops/limb.py on the CPU: the same seeded inputs through both, and
the outputs compared as integers (exact, limb for limb after regrouping the
JAX package's 16-bit limbs into the port's 32-bit ones)."""

import random

import numpy as np
import pytest
import torch

from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.fields import Fq as JFq
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.ops import pallas_field as pf
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.ops import kernels, limb

# One intra-op thread: the suite runs a test process per core, and torch's
# default of one thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

FIELDS = {"Fp": (Fp, JFp), "Fq": (Fq, JFq)}


def rand_elems(p, n, rng):
    """Edge values first: 0, 1, p - 1 and two all-ones limb patterns."""
    xs = [0, 1, p - 1, (1 << 254) - 1, (1 << 224) - 1]
    return xs + [rng.randrange(p) for _ in range(n - len(xs))]


def both(jF, xs, mont=True, shape=None):
    """The same values in the JAX layout and in the port's."""
    j = jF.pack_mont(xs, shape=shape) if mont else jF.pack(xs, shape=shape)
    return j, convert.limbs_from_numpy(np.asarray(j), device="cpu")


def same(port, jax_arr):
    return np.array_equal(convert.limbs_to_numpy(port), np.asarray(jax_arr))


@pytest.mark.parametrize("name", FIELDS)
def test_add_sub_neg_mul(name):
    field, jfield = FIELDS[name]
    rng = random.Random(101)
    jF, F = jlimb.device_field(jfield), limb.device_field(field)
    xs, ys = rand_elems(field.p, 64, rng), rand_elems(field.p, 64, rng)[::-1]
    (ja, a), (jb, b) = both(jF, xs), both(jF, ys)
    assert same(limb.add(F, a, b), jlimb.add(jF, ja, jb))
    assert same(limb.sub(F, a, b), jlimb.sub(jF, ja, jb))
    assert same(limb.neg(F, a), jlimb.neg(jF, ja))
    assert same(limb.mont_mul(F, a, b), jlimb.mont_mul(jF, ja, jb))
    assert F.unpack_mont(limb.mont_mul(F, a, b)) == [x * y % field.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", FIELDS)
def test_mont_roundtrip(name):
    field, jfield = FIELDS[name]
    rng = random.Random(102)
    jF, F = jlimb.device_field(jfield), limb.device_field(field)
    xs = rand_elems(field.p, 32, rng)
    ja, a = both(jF, xs, mont=False)
    am = limb.to_mont(F, a)
    assert same(am, jlimb.to_mont(jF, ja))
    assert same(limb.from_mont(F, am), jlimb.from_mont(jF, jlimb.to_mont(jF, ja)))
    assert F.unpack(limb.from_mont(F, am)) == xs
    assert F.pack_mont(xs, device="cpu").equal(am)


@pytest.mark.parametrize("name", FIELDS)
def test_pow_and_inv(name):
    field, jfield = FIELDS[name]
    rng = random.Random(103)
    jF, F = jlimb.device_field(jfield), limb.device_field(field)
    xs = rand_elems(field.p, 16, rng)
    ja, a = both(jF, xs)
    e = rng.randrange(1 << 200)
    assert same(limb.mont_pow(F, a, e), jlimb.mont_pow(jF, ja, e))
    assert same(limb.inv(F, a), jlimb.inv(jF, ja))
    assert F.unpack_mont(limb.mont_pow(F, a, 0)) == [1] * len(xs)


@pytest.mark.parametrize("name", FIELDS)
def test_prefix_mul_and_batch_inverse(name):
    """Row length 40 against the JAX package; 300 (three chunks a thread,
    not a multiple of 128) against the host; zeros inside."""
    field, jfield = FIELDS[name]
    p = field.p
    rng = random.Random(104)
    jF, F = jlimb.device_field(jfield), limb.device_field(field)
    xs = rand_elems(p, 40, rng)
    xs[7] = xs[20] = 0
    ja, a = both(jF, xs)
    assert same(limb.batch_inverse(F, a), jlimb.batch_inverse(jF, ja))
    nz = [x or 1 for x in xs]
    ja, a = both(jF, nz)
    assert same(limb.prefix_mul(F, a), jlimb.prefix_mul(jF, ja))

    long = rand_elems(p, 300, rng)
    long[150] = 0
    a = F.pack_mont(long, shape=(2, 150), device="cpu")
    got = F.unpack_mont(limb.prefix_mul(F, a))
    want = []
    for row in (long[:150], long[150:]):
        acc = 1
        for v in row:
            acc = acc * v % p
            want.append(acc)
    assert got == want
    assert F.unpack_mont(limb.batch_inverse(F, a)) == [pow(x, -1, p) if x else 0 for x in long]


def test_mont_mul_matches_pallas_interpret():
    """K1's plain version against the Pallas kernel in interpret mode."""
    rng = random.Random(105)
    jF, F = jlimb.device_field(JFq), limb.device_field(Fq)
    xs = rand_elems(Fq.p, 8, rng)
    ys = rand_elems(Fq.p, 8, rng)[::-1]
    (ja, a), (jb, b) = both(jF, xs), both(jF, ys)
    assert same(kernels.mont_mul_plain(F, a, b), pf.mont_mul(jF, ja, jb))


def test_is_zero_eq_select_and_multidim():
    F = limb.device_field(Fp)
    a = F.pack([0, 5, 0, 7], device="cpu")
    b = F.pack([0, 5, 1, 8], device="cpu")
    assert limb.is_zero(F, a).tolist() == [True, False, True, False]
    assert limb.eq(F, a, b).tolist() == [True, True, False, False]
    sel = limb.select(torch.tensor([True, False, True, False]), a, b)
    assert F.unpack(sel) == [0, 5, 0, 8]
    rng = random.Random(106)
    xs, ys = rand_elems(Fp.p, 24, rng), rand_elems(Fp.p, 24, rng)
    x2 = F.pack_mont(xs, shape=(4, 6), device="cpu")
    y2 = F.pack_mont(ys, shape=(4, 6), device="cpu")
    assert F.unpack_mont(limb.mont_mul(F, x2, y2)) == [x * y % Fp.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize(
    "bad",
    [
        lambda a: a.to(torch.int64),  # dtype
        lambda a: a[:4],  # not (8, ...)
        lambda a: a.t().contiguous().t(),  # not contiguous
    ],
    ids=["dtype", "limbs", "contiguity"],
)
def test_wrappers_reject_bad_operands(bad):
    F = limb.device_field(Fp)
    a = F.pack([1, 2, 3], device="cpu")
    with pytest.raises((TypeError, ValueError)):
        kernels.mont_mul(F, bad(a), a)
