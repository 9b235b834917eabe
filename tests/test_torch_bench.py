"""The port's benchmark entry point (bench_torch.py) without a card: its
settings, its JSON line (bench.py's keys), its protocol with the prover and
the verifier stubbed, and its refusal to run on the CPU. No proof runs
here; the card runs the real one (chip_smoke.py, tests/test_torch_cuda.py)."""

import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import bench_torch
from proof_systems_tpu_torch import prover, serialization, verifier

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]  # bench.py:98-106
VERIFY_KEYS = ["verify_s", "proof_bytes"]


@pytest.mark.parametrize("env,want", [
    ({}, (11, 2, False)),
    ({"BENCH_K": "15", "BENCH_REPS": "3", "BENCH_VERIFY": "1"}, (15, 3, True)),
    ({"BENCH_K": "16", "BENCH_REPS": "0", "BENCH_VERIFY": "0"}, (16, 1, False)),
], ids=["defaults", "k15-verify", "reps-at-least-one"])
def test_settings(env, want):
    assert bench_torch.settings(env) == want


@pytest.mark.parametrize("k,seconds,baseline", [(11, 0.3, 0.6), (15, 6.6, 3.3), (16, 2.0, 6.3),
                                                (12, 1.0, None)])
def test_result_line_has_bench_keys(k, seconds, baseline):
    out = json.loads(bench_torch.result_line(k, seconds))
    assert list(out) == BENCH_KEYS
    assert out["metric"] == f"kimchi_proving_time_2^{k}"
    assert out["value"] == round(seconds, 4) and out["unit"] == "s"
    assert out["vs_baseline"] == (None if baseline is None else round(baseline / seconds, 3))


def test_result_line_with_verify():
    line = bench_torch.result_line(16, 1.23456, verify_s=0.123456, proof_bytes=5306)
    assert "\n" not in line
    out = json.loads(line)
    assert list(out) == BENCH_KEYS + VERIFY_KEYS
    assert out["verify_s"] == 0.1235 and out["proof_bytes"] == 5306


@pytest.mark.parametrize("with_verify", [False, True], ids=["prove", "prove-verify"])
def test_measure_protocol(monkeypatch, with_verify):
    """One warm-up proof and `reps` timed ones; with verify, two
    verifications of the warm-up proof and its serialized size."""
    calls = {"prove": 0, "verify": 0}

    def create_proof(index, witness, rng):
        calls["prove"] += 1
        return f"proof{calls['prove']}"

    def verify(vk, proof, public, rng):
        calls["verify"] += 1
        assert (vk, proof, public) == ("vk", "proof1", [])
        return True

    monkeypatch.setattr(prover, "create_proof", create_proof)
    monkeypatch.setattr(verifier, "verify", verify)
    monkeypatch.setattr(serialization, "serialize_proof", lambda curve, proof: b"x" * 7)
    index = SimpleNamespace(device=torch.device("cpu"), curve=None, verifier_index=lambda: "vk")
    seconds, verify_s, proof_bytes = bench_torch.measure(index, None, 3, with_verify, rng=None)
    assert calls == {"prove": 4, "verify": 2 if with_verify else 0}
    assert seconds >= 0
    assert (verify_s is not None, proof_bytes) == ((True, 7) if with_verify else (False, None))


def test_measure_raises_when_the_proof_does_not_verify(monkeypatch):
    monkeypatch.setattr(prover, "create_proof", lambda index, witness, rng: "proof")
    monkeypatch.setattr(verifier, "verify", lambda vk, proof, public, rng: False)
    index = SimpleNamespace(device=torch.device("cpu"), curve=None, verifier_index=lambda: "vk")
    with pytest.raises(RuntimeError, match="failed to verify"):
        bench_torch.measure(index, None, 1, True, rng=None)


def test_main_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, BENCH_K="11"))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_bench_imports_no_jax():
    code = (
        "import sys\n"
        "import bench_torch\n"
        "bench_torch.settings({})\n"
        "bad = {k.split('.')[0] for k in sys.modules} & {'jax', 'jaxlib', 'proof_systems_tpu'}\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
