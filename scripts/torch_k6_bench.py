#!/usr/bin/env python3
"""Time K6 (ec_prefix_scan_parts) and K7 (ec_prefix_scan_fused) on the card
at the main path's shapes.

    python3 scripts/torch_k6_bench.py
    python3 scripts/torch_k6_bench.py --root DIR --shapes-only

Builds the CUDA kernels, prints the card's name and power limit and each K6
kernel's registers, local (stack) bytes and shared memory, and those of
K7's combine kernel (cudaFuncGetAttributes). Then, at each shape the main
path gives K6 (rows are the windows times the columns of an MSM, n its
points; chip_smoke.py's per-proof timing lists them), on random curve
points gathered on the card (affine-encoded for the mixed bucket scan,
doubled so that z != R for the general one), it prints:
  - the wrapper's time (CUDA events, mean of REPS calls after one), the
    team size and tile width it derives (kernels.parts_geometry), and
    chip_smoke.py's bound for the call;
  - whether the call's first row equals the plain version on that row, and
    the row alone through the kernel (a team split where the full call has
    none) too, as group elements.
Then K7 at its eight call shapes (the window sums' suffix scans of the
commits, the fold steps, the tail rounds and the sg MSM; general points):
the wrapper's time (mean of K7_REPS calls after one) beside chip_smoke.py's
bound, the host time a call takes to enqueue its work (the pace of a loop
that waits for the host), the team size and tile width, and whether the
result equals the plain version as group elements and, with one thread a
chunk, limb for limb. Then K7 at the z commit's 24 rows through its
launcher with one thread a chunk and with teams of 2 and 4 (the wrapper
takes 2). Then the
geometry sweep: the times of every team size S and tile width KT through
K6's launcher at the 15-column commit's 360 rows and the z commit's 24
rows, so that parts_geometry's choice can be read against the others.
Last, every team size and tile width on a row of 300 and on 2 rows of
65,537 against the plain version, both variants of K6 and K7.

--shapes-only times the public wrappers at K6's and K7's shapes and
nothing else, so that another checkout (given with --root) can be timed
beside this one in the same call. Needs a CUDA device; exits 2 without
one, 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import pathlib
import random
import sys
import time

import torch

REPS = 5
K7_REPS = 20
# (batch shape, n, mixed): the 15-column witness commit, the 7-chunk t
# commit, the b = 1 z commit and the verifier's MSM (bucket scans over
# 2^16 + 1 and 2^16 + 53 points, 24 windows), and the window sums of the
# 15-column and b = 1 MSMs (2,047 buckets)
SHAPES = [((24, 15), 65537, True), ((24, 7), 65537, True), ((24, 1), 65537, True),
          ((24, 1), 65589, True), ((24, 15), 2047, False), ((24, 1), 2047, False)]
# K7: (batch shape, n, where): the windows times the columns of an MSM, and
# its buckets but bucket 0 (2^c - 1)
K7_SHAPES = [((24, 15), 2047, "witness commit"), ((24, 7), 2047, "t commit"),
             ((24, 1), 2047, "z commit, verifier"), ((26, 2), 1023, "fold step 1"),
             ((29, 2), 511, "fold step 2"), ((32, 2), 255, "fold steps 3-5"),
             ((37, 2), 127, "11 tail rounds"), ((37, 1), 127, "sg MSM")]
# every (team size, tile width) k_ec_parts is built for
GEOMETRIES = [(1, 4), (1, 16), (2, 4), (4, 4), (8, 4), (16, 4)]


def points(dc, pool, batch, n, mixed, gen):
    idx = torch.randint(0, pool[0].shape[1], (n * torch.Size(batch).numel(),),
                        device=pool[0].device, generator=gen)
    src = pool if mixed else dc.double(pool)
    return [t[:, idx].reshape(8, *batch, n).contiguous() for t in src]


def timed_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_us(fn, reps: int = K7_REPS) -> float:
    """Host time a call takes to enqueue its work (mean of reps calls after
    one, the card not waited for inside): where a caller's loop waits for
    the host, as the opening's tail rounds do, this is its pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent),
                    help="checkout whose package and chip_smoke.py to use (default: this one)")
    ap.add_argument("--shapes-only", action="store_true",
                    help="time the wrappers at K6's and K7's shapes only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k6_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.ops import kernels
    from proof_systems_tpu_torch.ops.curve_ops import device_curve

    full = not args.shapes_only
    print(f"root {pathlib.Path(args.root).resolve()}: {chip_smoke.card_line()}", flush=True)
    lib = kernels.LIBRARY.load()
    print(f"build: CUDA kernels {lib.build_seconds:.1f} s", flush=True)
    if full:
        for name, (regs, local, static, dyn) in kernels.ec_prefix_scan_parts_attrs().items():
            print(f"K6 {name}: {regs} registers, {local} B local, {static} B static and "
                  f"{dyn} B dynamic shared memory", flush=True)
        regs, local, static, dyn = kernels.ec_prefix_scan_fused_attrs()
        print(f"K7 combine: {regs} registers, {local} B local, {static} B static and "
              f"{dyn} B dynamic shared memory", flush=True)
    dev = torch.device("cuda")
    dc = device_curve(Vesta)
    F = dc.F
    rng = random.Random(20261016)
    host = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator) for _ in range(1024)]
    pool = dc.to_jacobian(dc.pack_affine(host, device=dev))
    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def same_parts(got, want) -> bool:
        (gp, ge, gc), (wp, we, wc) = got, want
        return gc == wc and chip_smoke.point_err(F, gp, wp) == 0 and \
            chip_smoke.point_err(F, ge, we) == 0

    def same_scan(got, want, exact: bool) -> bool:
        """K7's output against the plain version's: as group elements, and
        limb for limb where exact."""
        limbs = all(torch.equal(a, b) for a, b in zip(got, want))
        return chip_smoke.point_err(F, got, want) == 0 and (limbs or not exact)

    ok = True
    for batch, n, mixed in SHAPES:
        pts = points(dc, pool, batch, n, mixed, gen)
        rows = torch.Size(batch).numel()
        team, kt = kernels.parts_geometry(rows, kernels.scan_chunk(n), sms)
        call = lambda: kernels.ec_prefix_scan_parts(F, *pts, mixed=mixed)  # noqa: E731
        ms = timed_ms(call)
        b_ms, b_by = chip_smoke.bound_ms("ec_prefix_scan_parts", [F, *pts], {"mixed": mixed})
        shape = "x".join(str(s) for s in (*batch, n))
        line = (f"K6 {'mixed' if mixed else 'general'} {shape:14s} S {team:2d} KT {kt:2d}: "
                f"{ms:9.4f} ms  bound {b_ms:.3g} ms ({b_by})")
        if full:
            part, excl, cp = call()
            one = [t[:, :1, :1].contiguous() for t in pts]
            want = kernels.ec_prefix_scan_parts_plain(F, *one, mixed=mixed)
            head = tuple(tuple(t[:, :1, :1] for t in g) for g in (part, excl))
            row_ok = same_parts((*head, cp), want)
            alone_ok = same_parts(kernels.ec_prefix_scan_parts(F, *one, mixed=mixed), want)
            ok &= row_ok and alone_ok
            line += f"  first row = plain: {row_ok}; alone = plain: {alone_ok}"
            del part, excl
        print(line, flush=True)
        del pts
        torch.cuda.empty_cache()

    for batch, n, where in K7_SHAPES:
        pts = points(dc, pool, batch, n, False, gen)
        team, kt = kernels.parts_geometry(torch.Size(batch).numel(), kernels.scan_chunk(n), sms)
        ms = timed_ms(lambda: kernels.ec_prefix_scan_fused(F, *pts), K7_REPS)
        host = enqueue_us(lambda: kernels.ec_prefix_scan_fused(F, *pts))
        b_ms, b_by = chip_smoke.bound_ms("ec_prefix_scan_fused", [F, *pts], {})
        shape = "x".join(str(s) for s in (*batch, n))
        line = (f"K7 {shape:10s} ({where}) S {team} KT {kt}: {ms:9.4f} ms  "
                f"bound {b_ms:.3g} ms ({b_by})  host {host:.1f} us a call")
        if full:
            same = same_scan(kernels.ec_prefix_scan_fused(F, *pts),
                             kernels.ec_prefix_scan_fused_plain(F, *pts), team == 1)
            ok &= same
            line += f"  = plain{' limb for limb' if team == 1 else ''}: {same}"
        print(line, flush=True)
        del pts
        torch.cuda.empty_cache()
    if not full:
        return 0

    pts = points(dc, pool, (24, 1), 2047, False, gen)
    cells = [f"S {team}: {timed_ms(lambda: kernels._ec_fused_launch(F, *pts, team, 4), K7_REPS):.4f}"
             for team in (1, 2, 4)]
    print("K7 24x1x2047 by team size, KT 4, ms: " + "; ".join(cells), flush=True)

    for batch, n in (((24, 15), 65537), ((24, 1), 65537)):
        pts = points(dc, pool, batch, n, True, gen)
        cells = [f"S {team} KT {kt}: {timed_ms(lambda: kernels._ec_parts_launch(F, *pts, True, team, kt)):.4f}"
                 for team, kt in GEOMETRIES]
        shape = "x".join(str(s) for s in (*batch, n))
        print(f"K6 mixed {shape} sweep, ms: " + "; ".join(cells), flush=True)
        del pts
        torch.cuda.empty_cache()

    for rows, n in ((1, 300), (2, 65537)):
        for mixed in (True, False):
            pts = points(dc, pool, (rows,), n, mixed, gen)
            want = kernels.ec_prefix_scan_parts_plain(F, *pts, mixed=mixed)
            bad = [(team, kt) for team, kt in GEOMETRIES
                   if not same_parts(kernels._ec_parts_launch(F, *pts, mixed, team, kt), want)]
            ok &= not bad
            print(f"K6 {'mixed' if mixed else 'general'} {rows}x{n}: every team size "
                  f"and tile width = plain: {not bad} {bad or ''}", flush=True)
        want = kernels.ec_prefix_scan_fused_plain(F, *pts)
        bad = [(team, kt) for team, kt in GEOMETRIES
               if not same_scan(kernels._ec_fused_launch(F, *pts, team, kt), want, team == 1)]
        ok &= not bad
        print(f"K7 {rows}x{n}: every team size and tile width = plain (limb for limb with "
              f"S = 1): {not bad} {bad or ''}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
