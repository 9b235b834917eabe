#!/usr/bin/env python3
"""Headline benchmark of the PyTorch + CUDA port: kimchi proof creation on
one CUDA card, vs the reference baseline.

    BENCH_K=16 BENCH_VERIFY=1 python3 bench_torch.py

The same protocol and output as bench.py, through the port: the bench
circuit of 2^k - 10 Const(1) generic gates over Vesta (BENCH_K, default 11;
0.6 s at 2^11, 3.3 s at 2^15 and 6.3 s at 2^16 in BASELINE.md), its
witness packed in Montgomery form on the card, one warm-up proof, then
BENCH_REPS (default 2) timed proofs, each ended by a synchronize, keeping
the fastest. With BENCH_VERIFY=1 it also verifies once as a warm-up and
once timed (verify_s), and reports the serialized proof's size
(proof_bytes).

Prints exactly one JSON line on stdout:
  {"metric": ..., "value": ..., "unit": "s", "vs_baseline": ...,
   "verify_s": ..., "proof_bytes": ...}
vs_baseline > 1 means faster than the reference (null for a k without a
baseline). Progress goes to stderr as `[bench]` lines, and the stage times
of one more proof, traced at the prover's checkpoints with a synchronize
before each, as `[trace]` lines. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

BASELINES = {11: 0.6, 15: 3.3, 16: 6.3}


def settings(env=os.environ) -> tuple[int, int, bool]:
    """(k, timed repetitions, verify) from BENCH_K, BENCH_REPS, BENCH_VERIFY."""
    k = int(env.get("BENCH_K", "11"))
    reps = max(1, int(env.get("BENCH_REPS", "2")))
    return k, reps, env.get("BENCH_VERIFY", "0") == "1"


def result_line(k: int, seconds: float, verify_s: float | None = None,
                proof_bytes: int | None = None) -> str:
    """bench.py's JSON line for a proving time of `seconds` at 2^k."""
    baseline = BASELINES.get(k)
    out = {
        "metric": f"kimchi_proving_time_2^{k}",
        "value": round(seconds, 4),
        "unit": "s",
        "vs_baseline": round(baseline / seconds, 3) if baseline else None,
    }
    if verify_s is not None:
        out["verify_s"] = round(verify_s, 4)
        out["proof_bytes"] = proof_bytes
    return json.dumps(out)


def progress(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(k: int, device=None, cache_dir=None):
    """The SRS (from its cache under build/), the bench circuit's
    constraint system, prover index and verifier index, and the witness
    packed in Montgomery form on `device` (the card unless the caller asks
    for the CPU). Returns (index, witness)."""
    from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.ops import limb
    from proof_systems_tpu_torch.poly_commitment.srs import SRS
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    n = 1 << k
    srs = SRS.create(Vesta, n, device=dev, cache_dir=cache_dir)
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, n - 10), public=0, max_poly_size=n,
                                 device=dev)
    index = ProverIndex(cs, Vesta, srs)
    index.verifier_index()  # set-up, outside the timed region
    host_witness = bench_witness(n - 10)
    witness = limb.device_field(Fp).pack_mont(
        [v for col in host_witness for v in col], shape=(len(host_witness), n - 10), device=dev)
    sync(dev)
    return index, witness


def prove_once(index, witness, rng):
    """One proof of the packed witness, ended by a synchronize: (proof,
    seconds on the host clock)."""
    from proof_systems_tpu_torch.prover import create_proof

    t0 = time.perf_counter()
    proof = create_proof(index, witness, rng)
    sync(index.device)
    return proof, time.perf_counter() - t0


def verify_once(index, proof, rng) -> float:
    """Seconds to verify `proof`; raises if it does not verify."""
    from proof_systems_tpu_torch.verifier import verify

    t0 = time.perf_counter()
    ok = verify(index.verifier_index(), proof, [], rng)
    sync(index.device)
    if not ok:
        raise RuntimeError("the benchmark proof failed to verify")
    return time.perf_counter() - t0


def measure(index, witness, reps: int, with_verify: bool, rng):
    """bench.py's protocol: a warm-up proof, with BENCH_VERIFY a warm-up and
    a timed verification and the proof's size, then the fastest of `reps`
    timed proofs. Returns (seconds, verify_s, proof_bytes)."""
    from proof_systems_tpu_torch.serialization import serialize_proof

    proof, warm = prove_once(index, witness, rng)
    progress(f"warmup proof: {warm:.1f}s")
    verify_s = proof_bytes = None
    if with_verify:
        progress(f"verify warmup: {verify_once(index, proof, rng):.1f}s")
        verify_s = verify_once(index, proof, rng)
        progress(f"verify steady: {verify_s:.4f}s")
        proof_bytes = len(serialize_proof(index.curve, proof))
        progress(f"proof size: {proof_bytes} B")
    seconds = min(prove_once(index, witness, rng)[1] for _ in range(reps))
    return seconds, verify_s, proof_bytes


def trace_stages(index, witness, rng) -> None:
    """One more proof with the tracer on (a synchronize before each of the
    prover's checkpoints), its stage times to stderr."""
    from proof_systems_tpu_torch.utils.tracing import TRACER

    TRACER.enable(hook=lambda: sync(index.device))
    try:
        prove_once(index, witness, rng)
    finally:
        TRACER.disable()
    for name, secs in TRACER.intervals():
        print(f"[trace] {name:40s} {secs * 1e3:10.3f} ms", file=sys.stderr, flush=True)


def main() -> int:
    k, reps, with_verify = settings()
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the port's benchmark runs only on the card",
              file=sys.stderr)
        return 2
    from proof_systems_tpu_torch.utils.rng import SystemRng

    t0 = time.perf_counter()
    index, witness = setup(k)
    progress(f"setup: {time.perf_counter() - t0:.1f}s on {torch.cuda.get_device_name(0)}; "
             f"warmup proof (2^{k}) ...")
    rng = SystemRng()
    seconds, verify_s, proof_bytes = measure(index, witness, reps, with_verify, rng)
    trace_stages(index, witness, rng)
    print(result_line(k, seconds, verify_s, proof_bytes), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
