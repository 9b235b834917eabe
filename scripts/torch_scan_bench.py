#!/usr/bin/env python3
"""Time K12 (mont_prefix_scan_parts), K9 (linear_scan) and K5
(mont_prefix_scan) on the card, at the main path's shapes, with every team
or block size.

    python3 scripts/torch_scan_bench.py
    python3 scripts/torch_scan_bench.py --root DIR --shapes-only

Builds the CUDA kernels and prints the card's name and power limit. Then
times the public wrappers at the main path's shapes, two ways (CUDA
events, mean of REPS calls after one): back to back, where a call that
takes the device less time than the host takes to enqueue it runs at the
host's pace, and behind a sleeping kernel, which hides the host and
leaves the device's time: K12 on one row of 65,536 (the batch inverse of
the permutation's ratio and z's prefix product), of 32,768 and of 16,384
(the batch inverses of the opening's first two fold steps), and on the
smallest K12 row, 8,193; K9 on one row of 65,536 with c = 1 and c =
omega^(n - 3) (the prover's two boundary divisions); K5 on one row of
8,192, 4,096 and 2,048 (the batch inverses of the opening's last three
fold steps), 2 and 1 (L and R of a round); each beside
chip_smoke.bound_ms.

Without --shapes-only it also times every team size K12 and K9 take
(device time), through their launchers, at those shapes and at 24 rows
of 65,537, and K5 at every block size from 32 to 512 threads; marks the
ones
kernels.field_scan_team and kernels.prefix_geometry pick, checks every
result against the plain version limb for limb, and prints the kernels'
registers and local (stack) bytes.

--shapes-only times the public wrappers and nothing else, so that another
checkout (given with --root) can be timed beside this one in the same call
(parent, change, change, parent). Needs a CUDA device; exits 2 without one,
1 on a mismatch.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import torch

REPS = 20
SEED = 20261020
HERE = pathlib.Path(__file__).resolve().parent


# Clock cycles of the sleeping kernel that the device-time calls queue
# behind: about 25 ms, far more than the host takes to enqueue REPS calls.
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


def rows_of(F, rows: int, n: int, dev, seed: int) -> torch.Tensor:
    from proof_systems_tpu_torch.ops import limb

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(-(1 << 31), 1 << 31, (8, rows, n), dtype=torch.int32, device=dev,
                      generator=gen)
    w[7] &= 0x3FFFFFFF  # below 2^254 < p
    return limb.to_mont(F, w.contiguous())


def cases(dev):
    """(label, wrapper name, args) at the main path's shapes."""
    from proof_systems_tpu_torch.fields import Fp, Fq
    from proof_systems_tpu_torch.ops import limb

    F = limb.device_field(Fp)
    Fb = limb.device_field(Fq)  # the opening's batch inverses: Vesta's base field
    n = 1 << 16
    omega = pow(Fp.root_of_unity(16), n - 3, Fp.p)
    out = [(f"K12 1x{m}", "mont_prefix_scan_parts", (F, rows_of(F, 1, m, dev, SEED + m)))
           for m in (n, n // 2, n // 4, 8193)]
    x = rows_of(F, 1, n, dev, SEED)
    out += [(f"K9 1x{n} c = {name}", "linear_scan", (F, x, c))
            for name, c in (("1", 1), ("omega^(n-3)", omega))]
    out += [(f"K5 1x{m}", "mont_prefix_scan", (Fb, rows_of(Fb, 1, m, dev, SEED + 3 + m)))
            for m in (8192, 4096, 2048, 2, 1)]
    return out


def same(got, want) -> bool:
    if torch.is_tensor(got):
        return torch.equal(got, want)
    return got[2] == want[2] and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def time_wrappers(kernels, chip_smoke, dev) -> None:
    for label, name, args in cases(dev):
        fn = kernels.WRAPPERS[name]
        ms = timed_ms(lambda: fn(*args))
        dev_ms = timed_ms(lambda: fn(*args), behind_sleep=True)
        b_ms, b_by = chip_smoke.bound_ms(name, args, {})
        print(f"{label:28s} back to back {ms:.4f} ms, device {dev_ms:.4f} ms  "
              f"bound {b_ms:.3g} ms ({b_by})", flush=True)


def sweep(kernels, chip_smoke, dev) -> bool:
    """Every team size through the launchers, checked against the plain
    version; the rule's pick marked."""
    ok = True
    sms = kernels._sm_count(dev)
    todo = cases(dev)
    F = todo[0][2][0]
    omega = next(args[2] for label, _, args in todo if label.endswith("omega^(n-3)"))
    todo += [("K12 24x65537", "mont_prefix_scan_parts", (F, rows_of(F, 24, 65537, dev, SEED + 1))),
             ("K9 24x65537 c = omega^(n-3)", "linear_scan",
              (F, rows_of(F, 24, 65537, dev, SEED + 2), omega))]
    for label, name, args in todo:
        F, x = args[0], args[1]
        rows, n = x[0].numel() // x.shape[-1], x.shape[-1]
        plain = getattr(kernels, name + "_plain")
        want = plain(*args)
        if name == "mont_prefix_scan":
            ok &= sweep_k5(kernels, label, F, x, want)
            continue
        if name == "mont_prefix_scan_parts":
            cp = kernels.scan_geometry(n)[2]
            launch = lambda team: kernels._prefix_parts_launch(F, x, team)  # noqa: E731
        else:
            cp = kernels.scan_chunk(n)
            launch = lambda team: kernels._linear_scan_launch(F, x, args[2], team)  # noqa: E731
        pick = kernels.field_scan_team(rows, cp, sms)
        for team in (1, 2, 4, 8, 16, 32):
            equal = same(launch(team), want)
            ok &= equal
            ms = timed_ms(lambda: launch(team), behind_sleep=True)
            mark = "  <- the rule's" if team == pick else ""
            print(f"{label:28s} S {team:2d} (sc {-(-cp // team):3d}) device {ms:.4f} ms; "
                  f"= plain: {equal}{mark}", flush=True)
    attrs = kernels.field_scan_attrs()
    print("field scan kernels: " + "; ".join(f"{k}: {r} registers, {loc} B local"
                                             for k, (r, loc, *_) in attrs.items()), flush=True)
    return ok


def sweep_k5(kernels, label, F, x, want) -> bool:
    """K5 at every block size, through the launcher."""
    ok = True
    pick = kernels.prefix_geometry(x.shape[-1])[0]
    for threads in (32, 64, 128, 256, 512):
        launch = lambda: kernels._mont_prefix_launch(F, x, threads)  # noqa: E731
        equal = same(launch(), want)
        ok &= equal
        ms = timed_ms(launch, behind_sleep=True)
        sc = kernels.prefix_geometry(x.shape[-1], threads)[1]
        mark = "  <- the rule's" if threads == pick else ""
        print(f"{label:28s} T {threads:4d} (sc {sc:3d}) device {ms:.4f} ms; = plain: {equal}{mark}",
              flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE.parent),
                    help="checkout whose package to use (default: this one)")
    ap.add_argument("--shapes-only", action="store_true",
                    help="time the public wrappers only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scan_bench: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    from proof_systems_tpu_torch.ops import kernels

    print(f"root {root}: {chip_smoke.card_line()}", flush=True)
    lib = kernels.LIBRARY.load()
    print(f"build: CUDA kernels {lib.build_seconds:.1f} s", flush=True)
    dev = torch.device("cuda")
    time_wrappers(kernels, chip_smoke, dev)
    if args.shapes_only:
        return 0
    return 0 if sweep(kernels, chip_smoke, dev) else 1


if __name__ == "__main__":
    sys.exit(main())
