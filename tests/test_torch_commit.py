"""The slice as a whole on the CPU at depth 2^6: SRS derivation, the witness
iNTT and the hiding commitment against the JAX package (whose CPU commit
path is the host golden MSM), and the convert.py round trips."""

import random

import numpy as np
import pytest
import torch

from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.ops import ntt as jntt
from proof_systems_tpu.poly_commitment.srs import SRS as JSRS
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import ntt
from proof_systems_tpu_torch.poly_commitment.srs import SRS

# One intra-op thread: the suite runs a test process per core, and torch's
# default of one thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

LOG_N = 6
DEPTH = 1 << LOG_N


@pytest.fixture(scope="module")
def srs_pair(tmp_path_factory):
    jsrs = JSRS.create(JVesta, DEPTH)
    srs = SRS.create(Vesta, DEPTH, device="cpu", cache_dir=tmp_path_factory.mktemp("srs"))
    return jsrs, srs


def test_srs_create_matches_jax(srs_pair, tmp_path):
    jsrs, srs = srs_pair
    assert srs.g == jsrs.g
    assert srs.h == jsrs.h
    again = SRS.create(Vesta, DEPTH, device="cpu", cache_dir=tmp_path)
    assert again.g == srs.g  # derived afresh into another cache
    cached = SRS.create(Vesta, DEPTH, device="cpu", cache_dir=tmp_path)
    assert cached.g == srs.g  # read back from the cache file
    from_jax = convert.srs_from_numpy(np.array(jsrs.g, dtype=object), jsrs.h, device="cpu")
    assert from_jax.g == srs.g and from_jax.h == srs.h


@pytest.mark.parametrize("b", [15, 1])
def test_intt_and_hiding_commit_match_jax(srs_pair, b):
    jsrs, srs = srs_pair
    rng = random.Random(500 + b)
    evals = [rng.randrange(Fp.p) for _ in range(b * DEPTH)]
    blinders = [[rng.randrange(Fp.p)] for _ in range(b)]

    jplan = jntt.ntt_plan(JFp, LOG_N)
    jw = jlimb.device_field(JFp).pack_mont(evals, shape=(b, DEPTH))
    jcoeffs = jplan.intt_t(jw, jplan.inv_twiddles)
    want = jsrs.commit_coeffs_dev(jcoeffs, 1, blinders)

    plan = ntt.ntt_plan(Fp, LOG_N, device="cpu")
    coeffs = plan.intt_t(convert.limbs_from_numpy(np.asarray(jw), device="cpu"), plan.inv_twiddles)
    assert np.array_equal(convert.limbs_to_numpy(coeffs), np.asarray(jcoeffs))
    got = srs.commit_coeffs_dev(coeffs, 1, blinders)
    assert [c.chunks for c in got] == [c.chunks for c in want]


def test_commit_host_chunks_and_non_hiding(srs_pair):
    """Two chunks from a polynomial longer than the SRS; no blinders."""
    jsrs, srs = srs_pair
    rng = random.Random(510)
    poly = [rng.randrange(Fp.p) for _ in range(DEPTH + 5)]
    got = srs.commit_coeffs_host([poly])
    assert got[0].chunks == jsrs.commit_coeffs_host([poly])[0].chunks
    assert got[0].chunks[1] == Vesta.msm(poly[DEPTH:], srs.g[:5])


def test_convert_round_trip_and_rejects():
    rng = np.random.default_rng(511)
    arr = rng.integers(0, 1 << 16, size=(16, 3, 5), dtype=np.uint32)
    t = convert.limbs_from_numpy(arr, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (8, 3, 5)
    assert np.array_equal(convert.limbs_to_numpy(t), arr)
    with pytest.raises(ValueError):
        convert.limbs_from_numpy(arr[:8], device="cpu")
    with pytest.raises(ValueError):
        convert.limbs_from_numpy(arr + (1 << 16), device="cpu")
