#!/usr/bin/env python3
"""Time K10 (sponge_squeeze2), K4 (mont_pow) and K11 (endo_inv) on the card,
and the latency of the Montgomery product they run on.

    python3 scripts/torch_chain_bench.py
    python3 scripts/torch_chain_bench.py --root DIR --shapes-only

Builds the CUDA kernels and prints the card's name and power limit. Then
times the public wrappers at the main path's shapes (K10 on one state, K4
at 1 and 3 elements with e = p - 2, at one element with e = 21, and at
24 x 65,537 with e = p - 2, K11 on 128 bits; CUDA events, mean of REPS
calls after one), two ways: back to back, where a call that takes the
device less time than the host takes to enqueue it runs at the host's
pace, and behind a sleeping kernel, which hides the host and leaves the
device's time; and checks each against its plain version limb for limb.

Without --shapes-only it also prints chip_smoke.py's product latency: one
thread's chain of dependent products of field.cuh's CIOS fe_mul and of
chain_field.cuh's fe_mul_lat, fe_sqr_lat and fe_dot3_lat (us a step, from
the difference of two chain lengths), K10's, K4's and K11's registers and
local (stack) bytes, and K11's inverse on edge values and its latency.

--shapes-only times the public wrappers and nothing else, so that another
checkout (given with --root) can be timed beside this one in the same call.
Needs a CUDA device; exits 2 without one, 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import pathlib
import random
import sys

import torch

REPS = 20
SEED = 20261019
HERE = pathlib.Path(__file__).resolve().parent


# Clock cycles of the sleeping kernel that the device-time calls queue
# behind: about 25 ms, more than the host takes to enqueue REPS calls.
SLEEP_CYCLES = 50_000_000


def timed_ms(fn, reps: int = REPS, behind_sleep: bool = False) -> float:
    """Mean time of `reps` calls after one on the stream (CUDA events); with
    behind_sleep, the calls are enqueued while a sleeping kernel holds the
    stream, so the interval holds the device's time alone."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if behind_sleep:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same(got, want) -> bool:
    if torch.is_tensor(got):
        return torch.equal(got, want)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def inputs(dev):
    """The main path's operands of K10, K4 and K11, from one seed."""
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp, Fq
    from proof_systems_tpu_torch.ops import kernels, limb
    from proof_systems_tpu_torch.poseidon import fq_kimchi

    rng = random.Random(SEED)
    Fqd, Fpd = limb.device_field(Fq), limb.device_field(Fp)
    R = Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator)
    L = Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator)
    sponge = (Fqd, fq_kimchi.rounds_full,
              Fqd.pack_mont([rng.randrange(Fq.p) for _ in range(3)], device=dev),
              Fqd.pack_mont([L[0], R[0]], device=dev), Fqd.pack_mont([L[1], R[1]], device=dev),
              kernels.sponge_consts(fq_kimchi, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = limb.to_mont(Fpd, torch.randint(-(1 << 31), 1 << 31, (8, 24, 65537), dtype=torch.int32,
                                          device=dev, generator=gen) & 0x3FFFFFFF)
    pows = [("1 element, e = p - 2", (Fpd, Fpd.pack_mont([rng.randrange(Fp.p)], device=dev),
                                       Fp.p - 2)),
            ("3 elements, e = p - 2", (Fpd, Fpd.pack_mont([rng.randrange(Fp.p) for _ in range(3)],
                                                          device=dev), Fp.p - 2)),
            ("1 element, e = 21", (Fpd, Fpd.pack_mont([rng.randrange(Fp.p)], device=dev), 21)),
            ("24x65537, e = p - 2", (Fpd, big.contiguous(), Fp.p - 2))]
    bits = torch.tensor([rng.randrange(2) for _ in range(128)], dtype=torch.int32, device=dev)
    return sponge, pows, (Fpd, Vesta.endos[1], bits)


def time_wrappers(kernels, sponge, pows, endo, check: bool) -> bool:
    ok = True
    cases = [("K10 sponge_squeeze2", kernels.sponge_squeeze2, kernels.sponge_squeeze2_plain,
              sponge)]
    cases += [(f"K4 mont_pow {label}", kernels.mont_pow, kernels.mont_pow_plain, args)
              for label, args in pows]
    cases += [("K11 endo_inv", kernels.endo_inv, kernels.endo_inv_plain, endo)]
    for label, fn, plain, args in cases:
        ms = timed_ms(lambda: fn(*args))
        dev_ms = timed_ms(lambda: fn(*args), behind_sleep=True)
        note = ""
        if check:
            equal = same(fn(*args), plain(*args))
            ok &= equal
            note = f"; = plain: {equal}"
        print(f"{label:36s} back to back {ms:.4f} ms, device {dev_ms:.4f} ms{note}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE.parent),
                    help="checkout whose package to use (default: this one)")
    ap.add_argument("--shapes-only", action="store_true",
                    help="time the public wrappers only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_chain_bench: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    from proof_systems_tpu_torch.ops import kernels

    print(f"root {root}: {chip_smoke.card_line()}", flush=True)
    lib = kernels.LIBRARY.load()
    print(f"build: CUDA kernels {lib.build_seconds:.1f} s", flush=True)
    dev = torch.device("cuda")
    sponge, pows, endo = inputs(dev)
    ok = time_wrappers(kernels, sponge, pows, endo, check=not args.shapes_only)
    if not args.shapes_only:
        chip_smoke.product_latency(kernels, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
