#!/usr/bin/env python3
"""Time K2 (jacobian_add), K3 (jacobian_double) and the IPA fold step's endo
ladder on the card at the main path's call shapes.

    python3 scripts/torch_k2_bench.py
    python3 scripts/torch_k2_bench.py --root DIR --shapes-only

Builds the CUDA kernels and prints the card's name and power limit and the
registers, local (stack) bytes and shared memory of K2, K3 and the ladder
(cudaFuncGetAttributes), with their SASS instruction counts and K8's
(cuobjdump). Then, on general Jacobian operands gathered on the card from
host points (with the doubling, negation and identity lanes): K2 at the
main path's call shapes and K3 at 65,537 points (the scaled basis's
doubling chain), each timed as the main path calls it (CUDA events around
back-to-back wrapper calls) and as device time alone (the calls captured
in a CUDA graph), beside chip_smoke.py's bound and the time recorded in
PERF.md where there is one; and the ladder at the five fold steps' sizes
of a k = 16 opening, beside its bound and, on the host clock,
synchronised, beside the loop it replaced (64 host iterations of two
selects, one K3 and one K2, timed the same way). Each is checked against
its plain version limb for limb, the ladder also against the host loop
and on chip_smoke.py's edge rows.

--shapes-only times the public wrappers at K2's and K3's shapes and the
host loop at the fold sizes, and nothing else, so that another checkout
(given with --root) can be timed beside this one in the same call. Needs a
CUDA device; exits 2 without one, 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import pathlib
import random
import re
import subprocess
import sys
import time

import torch

REPS = 20
HOST_REPS = 3
# K2's call shapes: where the main path calls it, and its time in PERF.md
# (NVIDIA H100 80GB HBM3, 700 W; None where none is recorded)
K2_SHAPES = [((24, 15, 4096), "witness commit, prefix at bucket ends", 1.1629),
             ((24, 15, 2048), "witness commit, bucket sums", None),
             ((24, 7, 4096), "t commit, prefix at bucket ends", None),
             ((37, 2, 256), "tail round, prefix at bucket ends", None)]
K3_SHAPE = (65537,)
FOLD_SIZES = [32768, 16384, 8192, 4096, 2048]
SEED = 20261018


def timed_ms(fn, reps: int = REPS) -> float:
    """Mean device time of `reps` calls after one (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = HOST_REPS) -> float:
    """Mean host time of `reps` calls after one, each ending in a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def graph_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: `reps` calls captured in a CUDA graph, the
    graph replayed and timed with CUDA events (no host work between the
    launches, so a short kernel's time is not the wrapper's host cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sass_sizes(kernels, names) -> dict[str, int]:
    """SASS instructions (16 bytes each) of each named kernel of the kernel
    library, from cuobjdump beside nvcc; empty where it cannot be read."""
    # one library since the sources became translation units; a parent checkout
    # (--root) may still build its curve kernels apart
    name = getattr(kernels, "LIBRARY_NAME", "curve_kernels.so")
    so = kernels.BUILD_DIR / "kernels" / kernels._source_tag() / name
    tool = pathlib.Path(kernels._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True)
    counts, current = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[current] += 1
    return {name: sum(v for k, v in counts.items() if name in k) for name in names
            if any(name in k for k in counts)}


def same(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def pool_points(curve, dc, rng, dev, count: int = 32):
    """The identity, `count` host points and their negations (k and
    k + count negate each other), affine-encoded on the card."""
    pts = [curve.scalar_mul(rng.randrange(1, curve.scalar.p), curve.generator)
           for _ in range(count)]
    return dc.to_jacobian(dc.pack_affine([None] + pts + [curve.neg(p) for p in pts], device=dev))


def k2_operands(dc, table, shape, dev):
    """Two general (doubled, z != R) operands of `shape` gathered from the
    pool: random pairs, P + P at every 7th position, P + (-P) at the next."""
    n = 1
    for d in shape:
        n *= d
    m = (table.x.shape[1] - 1) // 2
    gen = torch.Generator(device=dev).manual_seed(n)
    ip = torch.randint(0, 2 * m + 1, (n,), device=dev, generator=gen)
    iq = torch.randint(0, 2 * m + 1, (n,), device=dev, generator=gen)
    pos = torch.arange(n, device=dev)
    iq = torch.where(pos % 7 == 0, ip, iq)
    iq = torch.where((pos % 7 == 1) & (ip > 0), (ip - 1 + m) % (2 * m) + 1, iq)
    J = dc.double(table)
    return [[t[:, i].reshape(8, *shape).contiguous() for t in J] for i in (ip, iq)]


def ladder_input(table, n, dev):
    """(8, n) affine-encoded points (z = R) from the pool, none at infinity,
    as the fold steps' bases are: a point at infinity runs the add's
    doubling fallback at every step and holds its warp back (the edge rows
    check that case)."""
    gen = torch.Generator(device=dev).manual_seed(n)
    idx = torch.randint(1, table.x.shape[1], (n,), device=dev, generator=gen)
    return [t[:, idx].contiguous() for t in table]


def host_loop(dc, limb, JPoint, endo_q_m, p, bits):
    """The fold step's ladder as the port ran it before the ladder kernel:
    64 host iterations of two selects, one K3 and one K2."""
    F = dc.F
    x, y, z = p
    phix = limb.mont_mul(F, x, endo_q_m)
    negy = limb.neg(F, y)
    acc = dc.double(dc.add(JPoint(x, y, z), JPoint(phix, y, z)))
    for j in range(63, -1, -1):
        qx = limb.select(bits[2 * j + 1] == 1, phix, x)
        qy = limb.select(bits[2 * j] == 1, y, negy)
        acc = dc.add(dc.double(acc), JPoint(qx, qy, z))
    return acc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent),
                    help="checkout whose package and chip_smoke.py to use (default: this one)")
    ap.add_argument("--shapes-only", action="store_true",
                    help="time the wrappers and the host loop only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import chip_smoke
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.ops import kernels, limb
    from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve

    full = not args.shapes_only
    print(f"root {pathlib.Path(args.root).resolve()}: {chip_smoke.card_line()}", flush=True)
    lib = kernels.LIBRARY.load()
    print(f"build: CUDA kernels {lib.build_seconds:.1f} s", flush=True)
    if full:
        sizes = sass_sizes(kernels, [*kernels.GROUP_LAW_KERNELS.values(), "k_combine_windows"])
        for name, (regs, local, static, dyn) in kernels.group_law_attrs().items():
            print(f"{name}: {regs} registers, {local} B local, {static} B static and {dyn} B "
                  f"dynamic shared memory; {sizes.get(name)} SASS instructions", flush=True)
        print(f"k_combine_windows (K8): {sizes.get('k_combine_windows')} SASS instructions",
              flush=True)
    dev = torch.device("cuda")
    dc = device_curve(Vesta)
    F = dc.F
    rng = random.Random(SEED)
    table = pool_points(Vesta, dc, rng, dev)
    ok = True

    for shape, where, old_ms in K2_SHAPES:
        p, q = k2_operands(dc, table, shape, dev)
        ms = timed_ms(lambda: kernels.jacobian_add(F, *p, *q))
        dev_ms = graph_ms(lambda: kernels.jacobian_add(F, *p, *q))
        label = "x".join(map(str, shape))
        old = f"PERF.md {old_ms:.4f} ms" if old_ms else "PERF.md none"
        line = f"K2 {label:12s} ({where}): {ms:.4f} ms, graph {dev_ms:.4f} ms ({old})"
        if full:
            b_ms, b_by = chip_smoke.bound_ms("jacobian_add", [F, *p, *q], {})
            equal = same(kernels.jacobian_add(F, *p, *q), kernels.jacobian_add_plain(F, *p, *q))
            ok &= equal
            line += (f"; bound {b_ms:.4f} ms ({b_by}), the kernel at {b_ms / dev_ms:.1%} of "
                     f"its rate; = plain: {equal}")
        print(line, flush=True)

    x = ladder_input(table, K3_SHAPE[0], dev)
    ms = timed_ms(lambda: kernels.jacobian_double(F, *x))
    dev_ms = graph_ms(lambda: kernels.jacobian_double(F, *x))
    line = (f"K3 {K3_SHAPE[0]} (scaled basis): {ms:.4f} ms, graph {dev_ms:.4f} ms "
            "(PERF.md 0.0321 ms)")
    if full:
        b_ms, b_by = chip_smoke.bound_ms("jacobian_double", [F, *x], {})
        equal = same(kernels.jacobian_double(F, *x), kernels.jacobian_double_plain(F, *x))
        ok &= equal
        line += f"; bound {b_ms:.5f} ms ({b_by}); = plain: {equal}"
    print(line, flush=True)

    endo_q = Vesta.endos[0]
    endo_q_m = F.const_mont(endo_q, (1,), device=dev)
    bits = torch.tensor([rng.randrange(2) for _ in range(128)], dtype=torch.int32, device=dev)
    loop_total = ladder_total = 0.0
    for n in FOLD_SIZES:
        p = ladder_input(table, n, dev)
        loop_ms = wall_ms(lambda: host_loop(dc, limb, JPoint, endo_q_m, p, bits))
        loop_total += loop_ms
        if not full:
            print(f"ladder n = {n:5d}: host loop (K3 + K2 a step) {loop_ms:.4f} ms on the "
                  "host clock", flush=True)
            continue
        ms = timed_ms(lambda: kernels.endo_ladder(F, endo_q, *p, bits))
        wall = wall_ms(lambda: kernels.endo_ladder(F, endo_q, *p, bits))
        ladder_total += wall
        b_ms, b_by = chip_smoke.bound_ms("endo_ladder", [F, endo_q, *p, bits], {})
        got = kernels.endo_ladder(F, endo_q, *p, bits)
        equal = same(got, kernels.endo_ladder_plain(F, endo_q, *p, bits))
        loop_equal = same(got, host_loop(dc, limb, JPoint, endo_q_m, p, bits))
        ok &= equal and loop_equal
        products = n * chip_smoke.LADDER_PRODUCTS
        print(f"ladder n = {n:5d}: {ms:.4f} ms ({products / ms / 1e6:.2f} G products/s, "
              f"{ms * 1e3 / chip_smoke.LADDER_PRODUCTS:.3f} us a product of a thread's "
              f"chain); host clock {wall:.4f} ms against the host loop's {loop_ms:.4f}; bound "
              f"{b_ms:.4f} ms ({b_by}); = plain: {equal}; = host loop: {loop_equal}", flush=True)
    print(f"ladder over the five fold sizes, host clock: host loop {loop_total:.4f} ms"
          + (f", ladder kernel {ladder_total:.4f} ms" if full else ""), flush=True)
    if not full:
        return 0
    edge_ok = all(same(kernels.endo_ladder(*a), kernels.endo_ladder_plain(*a))
                  for _, a, _ in chip_smoke.ladder_edge_cases(rng, dev))
    ok &= edge_ok
    print(f"ladder edge rows (Vesta and Pallas, zero, one and random bits, a point at "
          f"infinity): = plain: {edge_ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
