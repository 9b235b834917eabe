#!/usr/bin/env python3
"""Time the plain versions' two families of field ops against each other.

    python3 scripts/torch_plain_arith_ab.py [--device cpu|cuda] [--threads 1] [--max-log 16]

The plain versions (proof_systems_tpu_torch/ops/kernels.py) compute a batch
of L lanes either on int64 16-bit limbs (`_Int16`: whole 16 x 16 product
tables, carries by one carry word) or on float64 ones (`_Float16`: float64
columns, REDC steps over p's nonzero limbs, carries rippled limb by limb);
`kernels.FLOAT_LANES[device]` is the one lane count from which they take
float64. This script times the complete add (`ec_add16`, the op of the
plain curve scans) and the Montgomery product (`mul16`) on random canonical
Fp operands of 2^3 ... 2^max-log lanes with each family forced, in turns
(int, float, int, float) in one process, checks that both give the same
limbs, and prints for each op the smallest lane count from which float64
wins at every larger count measured: the value FLOAT_LANES should hold.
Then it times `ec_add16` with its operand dedup (`kernels._duplicates`) and
without it (replaced by one that finds no repeats), on lanes that are all
distinct and on lanes that repeat four times each, in the same turns.
On the card it also prints the card's name and power limit. The tests set
one torch thread in most files, so `--threads 1` is the CPU's default.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from proof_systems_tpu_torch.fields import Fp  # noqa: E402
from proof_systems_tpu_torch.ops import kernels, limb  # noqa: E402

INT, FLOAT = 1 << 62, 0  # FLOAT_LANES values that force each family


def timed_ms(fn, device: torch.device, budget_s: float = 0.3) -> float:
    """Least time of one call over repeats that fill about budget_s."""
    fn()
    best, spent = float("inf"), 0.0
    while spent < budget_s:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        best, spent = min(best, dt), spent + dt
    return best * 1e3


def operands(P, lanes: int, device: torch.device, gen: torch.Generator):
    """Six (16, lanes) canonical limb tensors (below 2^254 < p), z nonzero."""
    out = []
    for _ in range(6):
        t = torch.randint(0, 1 << 16, (16, lanes), dtype=torch.int64, generator=gen)
        t[15] &= 0x3FFF
        t[0] |= 1
        out.append(t.to(device))
    return tuple(out[:3]), tuple(out[3:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=1, help="torch threads on the CPU")
    ap.add_argument("--max-log", type=int, default=None,
                    help="largest lane count's log2 (default 14 on the CPU, 20 on the card)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(args.threads)
    else:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    max_log = args.max_log or (14 if device.type == "cpu" else 20)
    P = kernels.field16(limb.device_field(Fp), device)
    float_lanes = kernels.FLOAT_LANES[device.type]
    gen = torch.Generator().manual_seed(1)
    ops = {"ec_add16": lambda p, q: kernels.ec_add16(P, p, q),
           "mul16": lambda p, q: (kernels.mul16(P, p[0], q[0]),)}
    wins = {name: {} for name in ops}
    for k in range(3, max_log + 1):
        p, q = operands(P, 1 << k, device, gen)
        for name, op in ops.items():
            times, outs = {INT: [], FLOAT: []}, {}
            for family in (INT, FLOAT, INT, FLOAT):
                kernels.FLOAT_LANES[device.type] = family
                try:
                    times[family].append(timed_ms(lambda: op(p, q), device))
                    outs[family] = op(p, q)
                except torch.cuda.OutOfMemoryError:  # the int tables outgrow the card
                    times[family].append(float("inf"))
                    torch.cuda.empty_cache()
            if len(outs) == 2:
                assert all(torch.equal(a, b) for a, b in zip(outs[INT], outs[FLOAT])), (name, k)
            t_int, t_float = min(times[INT]), min(times[FLOAT])
            wins[name][k] = t_float < t_int
            print(f"{name}, 2^{k} lanes: int {times[INT][0]:.4f} ms  float "
                  f"{times[FLOAT][0]:.4f} ms  int {times[INT][1]:.4f} ms  float "
                  f"{times[FLOAT][1]:.4f} ms  (faster: {'float' if wins[name][k] else 'int'})",
                  flush=True)
    for name, won in wins.items():
        from_k = next((k for k in sorted(won) if all(won[j] for j in won if j >= k)), None)
        at = "never" if from_k is None else f"2^{from_k}"
        print(f"{name}: float64 wins from {at} lanes on {device.type}", flush=True)
    kernels.FLOAT_LANES[device.type] = float_lanes
    dedup = kernels._duplicates
    for k in range(4, max_log + 1, 2):
        for repeat in (1, 4):
            p, q = operands(P, (1 << k) // repeat, device, gen)
            p, q = (tuple(t.repeat(1, repeat) for t in pt) for pt in (p, q))
            times, outs = {True: [], False: []}, {}
            for on in (True, False, True, False):
                kernels._duplicates = dedup if on else (lambda lanes: None)
                times[on].append(timed_ms(lambda: kernels.ec_add16(P, p, q), device))
                outs[on] = kernels.ec_add16(P, p, q)
            kernels._duplicates = dedup
            assert all(torch.equal(a, b) for a, b in zip(outs[True], outs[False])), k
            print(f"dedup, 2^{k} lanes, each {repeat} times: on {times[True][0]:.4f} ms  off "
                  f"{times[False][0]:.4f} ms  on {times[True][1]:.4f} ms  off "
                  f"{times[False][1]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
