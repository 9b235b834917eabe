"""The port's Poseidon layer and test randomness (proof_systems_tpu_torch.
poseidon, .utils.rng) against the JAX package's: the permutation (Python and
native), the Fq and Fr sponge transcripts, the copied constant tables and
the TestRng draws; and the reference's hash vectors (tests/vectors). Host
code on both sides; every comparison is exact."""

import json
import pathlib
import random

import pytest

from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.poseidon import params as jparams
from proof_systems_tpu.poseidon import sponge as jsponge
from proof_systems_tpu.poseidon.permutation import poseidon_block_cipher_py as jpermute
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.native import native_poseidon
from proof_systems_tpu_torch.poseidon import params, sponge
from proof_systems_tpu_torch.poseidon.permutation import poseidon_block_cipher_py
from proof_systems_tpu_torch.utils.rng import TestRng

NAMES = ["fp_kimchi", "fq_kimchi", "fp_legacy", "fq_legacy", "fp_3_60_0_5_5", "fq_3_60_0_5_5"]


@pytest.mark.parametrize("name", NAMES)
def test_tables_are_byte_copies(name):
    ours = (params._DATA / f"{name}.json").read_bytes()
    theirs = (jparams._DATA / f"{name}.json").read_bytes()
    assert ours == theirs
    assert getattr(params, name).round_constants == getattr(jparams, name).round_constants


@pytest.mark.parametrize("name", ["fp_kimchi", "fq_kimchi", "fq_legacy"])
def test_permutation_matches_jax(name):
    """The Python golden model and the native permutation on seeded
    states, including zero and p - 1 entries."""
    ours, theirs = getattr(params, name), getattr(jparams, name)
    p = ours.field.p
    rng = random.Random(801)
    states = [[0, 0, 0], [p - 1, 1, 0]] + [[rng.randrange(p) for _ in range(3)] for _ in range(6)]
    nat = native_poseidon(ours)
    for st in states:
        want = list(st)
        jpermute(theirs, want)
        got = list(st)
        poseidon_block_cipher_py(ours, got)
        assert got == want
        if nat is not None:
            assert nat.permute(st) == want


def _transcript(mod, curve, fq_params, fp_params, pts, rng_seed):
    """One Fq and one Fr transcript through every call of the sponges."""
    rng = random.Random(rng_seed)
    fr, fq = curve.scalar.p, curve.base.p
    out = []
    s = mod.FqSponge(fq_params, curve)
    s.absorb_fq([rng.randrange(fq), rng.randrange(fq)])
    s.absorb_g([pts[0], None, pts[1]])
    out.append(s.challenge_fq())
    s.absorb_fr([rng.randrange(fr), fr - 1])
    out.append(s.challenge().value)
    out.append(s.challenge().to_field(curve.endos[1], curve.scalar))
    out.append(s.squeeze_scalar_challenge_and_expand())
    out.append(s.digest())
    out.append(list(s.clone().sponge.state))
    r = mod.FrSponge(fp_params)
    r.absorb_multiple([rng.randrange(fr) for _ in range(5)])
    out.append(r.challenge().value)
    out.append(r.digest())
    out.append(mod.poseidon_hash(fp_params, [rng.randrange(fr) for _ in range(3)]))
    return out


def test_sponge_transcripts_match_jax():
    rng = random.Random(802)
    g = Vesta.generator
    pts = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(2)]
    got = _transcript(sponge, Vesta, params.fq_kimchi, params.fp_kimchi, pts, 803)
    want = _transcript(jsponge, JVesta, jparams.fq_kimchi, jparams.fp_kimchi, pts, 803)
    assert got == want


def test_scalar_challenge_edge_values():
    f = Vesta.scalar
    endo = Vesta.endos[1]
    for v in [0, (1 << 128) - 1, 0x5555 << 100, 1]:
        assert (sponge.ScalarChallenge(v).to_field(endo, f)
                == jsponge.ScalarChallenge(v).to_field(endo, JVesta.scalar))


def test_test_rng_draws_match_jax():
    ours, theirs = TestRng(17), JTestRng(17)
    for p in [Vesta.scalar.p, Vesta.base.p, 97]:
        assert [ours.field(p) for _ in range(20)] == [theirs.field(p) for _ in range(20)]


def _vectors(name):
    path = pathlib.Path(__file__).parent / "vectors" / f"{name}.json"
    return json.loads(path.read_text())["test_vectors"]


@pytest.mark.parametrize("name", ["kimchi", "legacy"])
def test_hash_vectors(name):
    """poseidon_hash over Fp equals the reference's vectors for both
    parameter sets (absorb every input, squeeze one element)."""
    prm = getattr(params, f"fp_{name}")
    for vec in _vectors(name):
        inputs = [Fp.from_bytes_le(bytes.fromhex(h)) for h in vec["input"]]
        assert sponge.poseidon_hash(prm, inputs) == Fp.from_bytes_le(bytes.fromhex(vec["output"]))
