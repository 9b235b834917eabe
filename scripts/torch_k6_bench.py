#!/usr/bin/env python3
"""Time K6 (ec_prefix_scan_parts) on the card at the main path's shapes.

    python3 scripts/torch_k6_bench.py

Builds the CUDA kernels, prints the card's name and power limit and each K6
kernel's registers, local (stack) bytes and shared memory
(cudaFuncGetAttributes). Then, at each shape the main path gives K6 (rows
are the windows times the columns of an MSM, n its points; chip_smoke.py's
per-proof timing lists them), on random curve points gathered on the card
(affine-encoded for the mixed bucket scan, doubled so that z != R for the
general one), it prints:
  - the wrapper's time (CUDA events, mean of REPS calls after one), the
    team size and tile width it derives (kernels.parts_geometry), and
    chip_smoke.py's bound for the call;
  - whether the call's first row equals the plain version on that row, and
    the row alone through the kernel (a team split where the full call has
    none) too, as group elements.
Then the geometry sweep: the times of every team size S and tile width KT
through the kernel's launcher at the 15-column commit's 360 rows and the z
commit's 24 rows, so that parts_geometry's choice can be read against the
others. Last, every team size and tile width on a row of 300 and on 2
rows of 65,537 against the plain version, both variants. Needs a CUDA
device; exits 2 without one, 1 on a mismatch.
"""

from __future__ import annotations

import pathlib
import random
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from proof_systems_tpu_torch.curves import Vesta  # noqa: E402
from proof_systems_tpu_torch.ops import kernels  # noqa: E402
from proof_systems_tpu_torch.ops.curve_ops import device_curve  # noqa: E402

REPS = 5
# (batch shape, n, mixed): the 15-column witness commit, the 7-chunk t
# commit, the b = 1 z commit and the verifier's MSM (bucket scans over
# 2^16 + 1 and 2^16 + 53 points, 24 windows), and the window sums of the
# 15-column and b = 1 MSMs (2,047 buckets)
# every (team size, tile width) k_ec_parts is built for
GEOMETRIES = [(1, 4), (1, 16), (2, 4), (4, 4), (8, 4), (16, 4)]
SHAPES = [((24, 15), 65537, True), ((24, 7), 65537, True), ((24, 1), 65537, True),
          ((24, 1), 65589, True), ((24, 15), 2047, False), ((24, 1), 2047, False)]


def points(dc, pool, batch, n, mixed, gen):
    idx = torch.randint(0, pool[0].shape[1], (n * torch.Size(batch).numel(),),
                        device=pool[0].device, generator=gen)
    src = pool if mixed else dc.double(pool)
    return [t[:, idx].reshape(8, *batch, n).contiguous() for t in src]


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


def same(F, got, want) -> bool:
    (gp, ge, gc), (wp, we, wc) = got, want
    return gc == wc and chip_smoke.point_err(F, gp, wp) == 0 and chip_smoke.point_err(F, ge, we) == 0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k6_bench: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    lib = kernels.LIBRARY.load()
    print(f"build: CUDA kernels {lib.build_seconds:.1f} s", flush=True)
    for name, (regs, local, static, dyn) in kernels.ec_prefix_scan_parts_attrs().items():
        print(f"K6 {name}: {regs} registers, {local} B local, {static} B static and "
              f"{dyn} B dynamic shared memory", flush=True)
    dev = torch.device("cuda")
    dc = device_curve(Vesta)
    F = dc.F
    rng = random.Random(20261016)
    host = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator) for _ in range(1024)]
    pool = dc.to_jacobian(dc.pack_affine(host, device=dev))
    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ok = True
    for batch, n, mixed in SHAPES:
        pts = points(dc, pool, batch, n, mixed, gen)
        rows = torch.Size(batch).numel()
        team, kt = kernels.parts_geometry(rows, kernels.scan_chunk(n), sms)
        call = lambda: kernels.ec_prefix_scan_parts(F, *pts, mixed=mixed)  # noqa: E731
        ms = timed_ms(call)
        b_ms, b_by = chip_smoke.bound_ms("ec_prefix_scan_parts", [F, *pts], {"mixed": mixed})
        part, excl, cp = call()
        one = [t[:, :1, :1].contiguous() if len(batch) == 2 else t[:, :1].contiguous() for t in pts]
        want = kernels.ec_prefix_scan_parts_plain(F, *one, mixed=mixed)
        head = tuple(tuple(t[:, :1, :1] if len(batch) == 2 else t[:, :1] for t in g)
                     for g in (part, excl))
        row_ok = same(F, (*head, cp), want)
        alone_ok = same(F, kernels.ec_prefix_scan_parts(F, *one, mixed=mixed), want)
        ok &= row_ok and alone_ok
        shape = "x".join(str(s) for s in (*batch, n))
        print(f"K6 {'mixed' if mixed else 'general'} {shape:14s} S {team:2d} KT {kt:2d}: "
              f"{ms:9.4f} ms  bound {b_ms:.3g} ms ({b_by})  first row = plain: {row_ok}; "
              f"alone = plain: {alone_ok}", flush=True)
        del pts, part, excl
        torch.cuda.empty_cache()

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
                   if not same(F, kernels._ec_parts_launch(F, *pts, mixed, team, kt), want)]
            ok &= not bad
            print(f"K6 {'mixed' if mixed else 'general'} {rows}x{n}: every team size "
                  f"and tile width = plain: {not bad} {bad or ''}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
