"""The multi-device dry run: the sharded proving pipeline over N ranks.

Counterpart of the JAX package's dryrun_multichip (__graft_entry__.py:35),
written for torch.distributed: `dryrun_multichip(n)` spawns n ranks
(parallel/spawn.py; NCCL on n cards, or gloo with device="cpu") and each
runs the JAX dry run's three steps:

  1. the column-sharded NTT / pointwise / iNTT step with its cross-rank
     modular sum (parallel/mesh.sharded_ntt_step);
  2. the row-sharded four-step NTT (parallel/ntt.DistNttPlan), forward
     against the single-device plan and inverse back to the input;
  3. a whole proof of bench_circuit(nc - 10) at nc = 64 on the mesh (the
     sharded MSMs and the row-sharded quotient), which must verify and be
     byte-identical to the single-device proof that rank 0 makes after it
     with the mesh off.

    python -m proof_systems_tpu_torch.parallel.dryrun --devices N [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

NC = 64


def _ntt_round_trip(mesh) -> None:
    from ..fields import Fp
    from ..ops import limb, ntt
    from .ntt import DistNttPlan

    W = mesh.size
    log_n = max(6, 2 * (W.bit_length() - 1))
    dp = DistNttPlan(Fp, log_n, mesh)
    F = limb.device_field(Fp)
    vals = [(i * 37 + 5) % Fp.p for i in range(dp.n)]
    x = F.pack_mont(vals, shape=(dp.n,), device=mesh.device)
    evals = F.unpack_mont(dp.to_natural(dp.ntt(dp.shard_input(x))))
    if evals != F.unpack_mont(ntt.ntt_plan(Fp, log_n, device=mesh.device).ntt(x)):
        raise AssertionError("distributed NTT mismatch against the single-device plan")
    e = dp.shard_input(F.pack_mont(evals, shape=(dp.n,), device=mesh.device))
    if F.unpack_mont(dp.to_natural(dp.intt(e))) != vals:
        raise AssertionError("distributed iNTT failed to invert")


def _prove(device, seed: int):
    from ..circuits.builders import bench_circuit, bench_witness
    from ..circuits.constraints import ConstraintSystem
    from ..curves import Vesta
    from ..fields import Fp
    from ..poly_commitment.srs import SRS, derive_g, derive_h
    from ..prover import create_proof
    from ..prover_index import ProverIndex
    from ..serialization import serialize_proof
    from ..utils.rng import TestRng
    from ..verifier import verify

    srs = SRS(Vesta, [derive_g(Vesta, i) for i in range(NC)], derive_h(Vesta), device)
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, NC - 10), public=0, max_poly_size=NC,
                                 device=device)
    index = ProverIndex(cs, Vesta, srs)
    proof = create_proof(index, bench_witness(NC - 10), TestRng(seed))
    if not verify(index.verifier_index(), proof, [], TestRng(seed + 1)):
        raise AssertionError("the proof failed to verify")
    return serialize_proof(Vesta, proof)


def _dryrun_rank(mesh) -> dict:
    from .auto import data_mesh
    from .mesh import sharded_ntt_step

    if mesh is None:
        raise AssertionError("no data mesh inside a rank")
    sharded_ntt_step(mesh, mesh.size)
    _ntt_round_trip(mesh)
    raw = _prove(mesh.device, 12)
    same = None
    if mesh.rank == 0:
        os.environ["PST_MESH"] = "0"
        try:
            if data_mesh() is not None:
                raise AssertionError("PST_MESH=0 left the mesh on")
            same = _prove(mesh.device, 12) == raw
        finally:
            del os.environ["PST_MESH"]
        if not same:
            raise AssertionError("the mesh's proof differs from the single-device proof")
    return dict(proof=raw, same_as_single=same)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the three steps on n_devices ranks: NCCL on as many cards (the
    default; raises when fewer are present) or gloo with device="cpu".
    Returns {"proof": the serialized proof, "ranks": n_devices}; every
    rank's proof is the same, and equal to the single-device proof."""
    from .spawn import Ranks

    outs = Ranks(_dryrun_rank, n_devices, device).results()
    if any(o["proof"] != outs[0]["proof"] for o in outs):
        raise AssertionError("the ranks' proofs differ")
    if outs[0]["same_as_single"] is not True:
        raise AssertionError("rank 0 did not match the single-device proof")
    return dict(proof=outs[0]["proof"], ranks=n_devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the sharded proving pipeline over N ranks")
    ap.add_argument("--devices", type=int, required=True, help="ranks, one per device")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU, not cards")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.devices, "cpu" if args.cpu else None)
    print(f"dryrun: {out['ranks']} ranks; the sharded proof of {NC} rows "
          f"({len(out['proof'])} bytes) verifies and equals the single-device proof")
    return 0


if __name__ == "__main__":
    sys.exit(main())
