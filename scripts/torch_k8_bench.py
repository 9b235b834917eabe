#!/usr/bin/env python3
"""Time K8 (combine_windows) on the card at the main path's call shapes.

    python3 scripts/torch_k8_bench.py
    python3 scripts/torch_k8_bench.py --root DIR --shapes-only

Builds the CUDA kernels and prints the card's name and power limit and the
K8 kernel's registers, local (stack) bytes and shared memory
(cudaFuncGetAttributes). Then, at each (W, b, c) the main path gives K8 (W
windows of b columns, window size c; chip_smoke.py's per-proof timing lists
them), on random general Jacobian window sums, it prints the wrapper's time
(CUDA events, mean of REPS calls after one), the time of the one-thread
kernel it replaced where PERF.md records one, one column's chain (dependent
products, levels) with the time a product and a level, and chip_smoke.py's
bound for the call, and checks the result against the plain version limb
for limb. Last, the same check on chip_smoke.py's K8 edge rows (identity
columns, the doubling and infinity fallbacks, W = 1, c = 1, b = 33 and 130).

--shapes-only times the public wrapper at the six shapes and nothing else,
so that another checkout (given with --root) can be timed beside this one
in the same call. Needs a CUDA device; exits 2 without one, 1 on a
mismatch.
"""

from __future__ import annotations

import argparse
import pathlib
import random
import sys

import torch

REPS = 20
# (W, b, c): where the main path calls it, and the time of the one-thread
# kernel it replaced there (NVIDIA H100 80GB HBM3, 700 W; PERF.md; None
# where it was not timed)
SHAPES = [((26, 2, 10), "fold step 1", None), ((29, 2, 9), "fold step 2", None),
          ((32, 2, 8), "fold steps 3-5", None), ((37, 2, 7), "11 tail rounds", 2.6041),
          ((37, 1, 7), "sg MSM", None), ((24, 1, 11), "verifier MSM", 2.1745)]


def timed_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def same(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent),
                    help="checkout whose package and chip_smoke.py to use (default: this one)")
    ap.add_argument("--shapes-only", action="store_true",
                    help="time the wrapper at the six shapes only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k8_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.ops import kernels
    from proof_systems_tpu_torch.ops.curve_ops import device_curve

    print(f"root {pathlib.Path(args.root).resolve()}: {chip_smoke.card_line()}", flush=True)
    lib = kernels.LIBRARY.load()
    print(f"build: CUDA kernels {lib.build_seconds:.1f} s", flush=True)
    if not args.shapes_only:
        regs, local, static, dyn = kernels.combine_windows_attrs()
        print(f"K8: {regs} registers, {local} B local, {static} B static and {dyn} B dynamic "
              "shared memory", flush=True)
    dev = torch.device("cuda")
    dc = device_curve(Vesta)
    F = dc.F
    rng = random.Random(20261017)
    pool = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator) for _ in range(256)]
    # general Jacobian window sums: doubled, so z != R
    J = dc.double(dc.to_jacobian(dc.pack_affine(pool, device=dev)))
    gen = torch.Generator(device=dev).manual_seed(8)
    ok = True
    for (W, b, c), where, old_ms in SHAPES:
        idx = torch.randint(0, len(pool), (W * b,), device=dev, generator=gen)
        wins = [t[:, idx].reshape(8, W, b).contiguous() for t in J]
        ms = timed_ms(lambda: kernels.combine_windows(F, c, *wins))
        b_ms, b_by = chip_smoke.bound_ms("combine_windows", [F, c, *wins], {})
        shape = f"{W}x{b} c={c}"
        old = f"one-thread kernel {old_ms:.4f} ms" if old_ms else "one-thread kernel not timed"
        if args.shapes_only:
            print(f"K8 {shape:12s} ({where}): {ms:.4f} ms ({old})", flush=True)
            continue
        products, levels = chip_smoke.k8_chain(W, c)
        equal = same(kernels.combine_windows(F, c, *wins),
                     kernels.combine_windows_plain(F, c, *wins))
        ok &= equal
        print(f"K8 {shape:12s} ({where}): {ms:.4f} ms ({old}); chain {products} products in "
              f"{levels} levels a column, {ms * 1e3 / products:.4f} us a product, "
              f"{ms * 1e3 / levels:.4f} us a level; bound {b_ms:.3g} ms ({b_by}); = plain: {equal}",
              flush=True)
    if args.shapes_only:
        return 0
    for W, b, c in chip_smoke.K8_EDGE_SHAPES:
        wins = chip_smoke.k8_windows(Vesta, dc, rng, W, b, c, dev)
        equal = same(kernels.combine_windows(F, c, *wins),
                     kernels.combine_windows_plain(F, c, *wins))
        ok &= equal
        print(f"K8 edge rows {W}x{b} c={c}: = plain: {equal}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
