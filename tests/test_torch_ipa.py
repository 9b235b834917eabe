"""The port's IPA opening (proof_systems_tpu_torch.poly_commitment.ipa) on
the CPU, where the plain versions of the kernels run its device round loop,
against the JAX package's open_proof at n = 16: the openings agree field for
field, with and without fold steps, and the JAX verifier accepts the port's.
Also eval_at2 against the JAX package's and host Horner. Every comparison is
exact. The port's verifier: tests/test_torch_ipa_verify.py."""

import random

import jax.numpy as jnp
import pytest
import torch

from torch_ipa_case import Case, f, host_eval

from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.ops import poly as jpoly
from proof_systems_tpu.poly_commitment import ipa as jipa
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.ops import limb, poly

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    return Case()


def fields(p):
    return (p.lr, p.delta, p.z1, p.z2, p.sg)


@pytest.mark.parametrize("tail_target", [2048, 4], ids=["tail_only", "two_fold_steps"])
def test_open_proof_matches_jax(case, tail_target):
    """tail_target = 2048: all four rounds masked; 4: two fold steps (the
    endo ladder over the basis), then two masked rounds."""
    got = case.open(tail_target)
    want = case.jax_opening()
    assert len(got.lr) == 4
    assert fields(got) == fields(want)


def test_jax_verifier_accepts_the_ports_opening(case):
    ours = case.open(2048)
    assert jipa.verify_batch(case.jsrs, case.batch(ours, jax_side=True), JTestRng(2))


def test_eval_at2_matches_jax_and_host():
    pyrng = random.Random(12)
    b, L = 3, 24
    coeffs = [[pyrng.randrange(f.p) for _ in range(L)] for _ in range(b)]
    za, zb = pyrng.randrange(f.p), pyrng.randrange(f.p)
    F = limb.device_field(f)
    c_t = F.pack_mont([x for row in coeffs for x in row], shape=(b, L), device="cpu")
    got = poly.eval_at2(F, c_t, poly.powers_dev(F, za, L, device="cpu"),
                        poly.powers_dev(F, zb, L, device="cpu"))
    assert got == ([host_eval(c, za) for c in coeffs], [host_eval(c, zb) for c in coeffs])

    JF = jlimb.device_field(JVesta.scalar)
    jc = jnp.asarray(convert.limbs_to_numpy(c_t))
    want = jpoly.eval_at2(JF, jc, jpoly.powers_dev(JF, za, L), jpoly.powers_dev(JF, zb, L))
    assert got == want


def test_eval_at_matches_jax_and_host():
    """One point, with the power vector shared by the rows (8, L) and given
    per row (8, b, L)."""
    pyrng = random.Random(13)
    b, L = 2, 21
    coeffs = [[pyrng.randrange(f.p) for _ in range(L)] for _ in range(b)]
    z = pyrng.randrange(f.p)
    F = limb.device_field(f)
    c_t = F.pack_mont([x for row in coeffs for x in row], shape=(b, L), device="cpu")
    pw = poly.powers_dev(F, z, L, device="cpu")
    want = [host_eval(c, z) for c in coeffs]
    assert poly.eval_at(F, c_t, pw) == want
    assert poly.eval_at(F, c_t, pw[:, None, :].expand(8, b, L)) == want

    JF = jlimb.device_field(JVesta.scalar)
    jc = jnp.asarray(convert.limbs_to_numpy(c_t))
    assert jpoly.eval_at(JF, jc, jpoly.powers_dev(JF, z, L)) == want
