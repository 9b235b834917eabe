"""The port's verify_batch (proof_systems_tpu_torch.poly_commitment.ipa) on
the CPU, where the plain versions of the kernels run its MSM, at n = 16: it
accepts the JAX package's opening (which equals the port's,
tests/test_torch_ipa.py) and rejects the corrupted cases of
tests/test_poly_commitment.py."""

import pytest
import torch
from torch_ipa_case import Case, f

from proof_systems_tpu_torch.poly_commitment import ipa
from proof_systems_tpu_torch.poly_commitment.commitment import combined_inner_product
from proof_systems_tpu_torch.utils.rng import TestRng

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    return Case()


def test_verify_accepts_the_jax_opening(case):
    assert ipa.verify_batch(case.srs, case.batch(case.jax_opening()), TestRng(2))


def test_verify_rejects_a_changed_evaluation(case):
    """One evaluation changed and cip recomputed from the changed values."""
    bad = [[list(pt) for pt in ev] for ev in case.evals]
    bad[0][1][0] = (bad[0][1][0] + 1) % f.p
    bad_cip = combined_inner_product(f, case.polyscale, case.evalscale, bad)
    assert not ipa.verify_batch(case.srs, case.batch(case.jax_opening(), bad, bad_cip), TestRng(3))


def test_verify_rejects_z1_plus_one(case):
    opening = case.jax_opening()
    z1 = ipa.OpeningProof(**{**vars(opening), "z1": (opening.z1 + 1) % f.p})
    assert not ipa.verify_batch(case.srs, case.batch(z1), TestRng(4))
