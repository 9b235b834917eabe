"""Arrabbiata CLI (reference: arrabbiata/src/cli.rs + main.rs), on the card.

    python -m proof_systems_tpu_torch.folding.cli execute \
        --zkapp square -n 10 --srs-size 8 [--no-decider]

Counterpart of proof_systems_tpu/folding/cli.py, with the same stderr lines
and the same JSON line. The commitments and the decider run on the card;
`execute(..., device="cpu")` runs them through the plain versions.

Runs N folding iterations of the square-and-absorb app circuit over the
Pasta cycle (interpreter.rs run_app: z' = z^2, absorbed into the running
transcript), logging per-iteration wall time like main.rs's
"Iteration {i} fully proven in {elapsed} us" debug line, then runs the
decider and prints one JSON fold-throughput summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def execute(zkapp: str, n_iters: int, srs_log2: int, decide: bool = True,
            device=None) -> dict:
    from ..curves import Pallas, Vesta
    from ..poly_commitment.srs import SRS
    from ..runtime import resolve_device
    from ..utils import TestRng
    from .ivc import IVC, verifier_circuit_size

    if zkapp != "square":
        raise SystemExit(f"unknown zkapp {zkapp!r} (available: square)")
    srs_size = 1 << srs_log2
    rows = srs_size
    if rows < verifier_circuit_size() + 1:
        raise SystemExit(
            f"--srs-size 2^{srs_log2} too small: the verifier circuit needs "
            f">= {verifier_circuit_size() + 1} rows"
        )
    dev = resolve_device(device)
    sv = SRS.create(Vesta, srs_size, device=dev)
    sp = SRS.create(Pallas, srs_size, device=dev)
    rng = TestRng(42)
    ivc = IVC(sv, sp, n=rows, rng=rng)

    z = 2
    t0 = time.time()
    per_iter = []
    for i in range(n_iters):
        ti = time.time()
        z, digest = ivc.step(i, z)
        dt = time.time() - ti
        per_iter.append(dt)
        print(
            f"Iteration {i} fully proven in {dt*1e6:.0f} us "
            f"(z = 0x{z:x}, digest = 0x{digest:x})",
            file=sys.stderr,
            flush=True,
        )
    total = time.time() - t0

    decided = None
    if decide:
        td = time.time()
        from ..circuits.domains import EvaluationDomains

        domain_by_field = {
            Vesta.scalar: EvaluationDomains.create(Vesta.scalar, rows, device=dev),
            Pallas.scalar: EvaluationDomains.create(Pallas.scalar, rows, device=dev),
        }
        decided = ivc.decide(domain_by_field, rng)
        print(f"Decider: {decided} in {time.time()-td:.2f}s", file=sys.stderr)

    out = {
        "metric": "arrabbiata_fold_throughput",
        "zkapp": zkapp,
        "iterations": n_iters,
        "rows_per_instance": rows,
        "total_s": round(total, 4),
        "folds_per_s": round(n_iters / total, 3) if total else None,
        "decider_ok": decided,
    }
    print(json.dumps(out))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="arrabbiata",
        description="Arrabbiata - a generic recursive SNARK based on folding schemes",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("execute", help="run the IVC over a zkapp")
    ex.add_argument("--zkapp", required=True, help="the selected zkapp to execute")
    ex.add_argument("-n", type=int, required=True, help="Number of iterations")
    ex.add_argument(
        "--srs-size", type=int, required=True, help="The SRS size, given in log2"
    )
    ex.add_argument(
        "--no-decider", action="store_true", help="skip the final decider"
    )
    args = p.parse_args(argv)
    if args.cmd == "execute":
        execute(args.zkapp, args.n, args.srs_size, decide=not args.no_decider)


if __name__ == "__main__":
    main()
