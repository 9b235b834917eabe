#!/usr/bin/env python3
"""Time the two carry branches of the port's torch field layer on the card.

    python3 scripts/torch_carry_ab.py

`limb.add` resolves carries either as one carry word (`kernels._carries`,
a fixed handful of torch ops) or limb by limb (16 small ops a step);
`kernels._serial` picks one from the batch width. This script times
`limb.add` on random canonical Fp tensors of 2^12 ... 2^22 elements with
each branch forced, twice in turns (carry, ripple, carry, ripple) inside one
process, checks that both give the same limbs, and prints the card's name
and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from proof_systems_tpu_torch.fields import Fp  # noqa: E402
from proof_systems_tpu_torch.ops import kernels, limb  # noqa: E402


def timed_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_carry_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    F = limb.device_field(Fp)
    dev = torch.device("cuda")
    rule = kernels._serial
    gen = torch.Generator().manual_seed(1)
    for log_n in (12, 16, 18, 19, 20, 21, 22):
        w = torch.randint(0, 1 << 31, (8, 1 << log_n), generator=gen, dtype=torch.int64)
        w[7] %= Fp.p >> 224  # below 2^254 < p: canonical
        a = w.to(torch.int32).to(dev)
        b = a.roll(1, dims=1).contiguous()
        times = []
        for label, serial in (("carry", False), ("ripple", True)) * 2:
            kernels._serial = lambda t, s=serial: s
            times.append(f"{label} {timed_ms(lambda: limb.add(F, a, b)):.4f} ms")
            if label == "carry":
                carry_out = limb.add(F, a, b)
            elif not torch.equal(carry_out, limb.add(F, a, b)):
                raise AssertionError(f"the branches disagree at 2^{log_n}")
        kernels._serial = rule
        print(f"limb.add, 2^{log_n} elements: " + "  ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
