"""Time one emulated-warp test of tests/test_torch_scan_host.py with the
harness's threads pinned to one CPU (tests/torch_host_harness.py, as the
tests run) and unpinned (run_pinned replaced by a plain subprocess.run in
the pytest process), on an idle machine and beside BUSY processes that spin.

    python scripts/host_harness_pin_ab.py [--busy 16] [--case EXPR]

Prints one line a run: load, pinning, seconds."""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = "test_k9_device_code_matches_python and 65537-1-omega"
UNPINNED = """
import subprocess, sys
sys.path.insert(0, "tests")
import pytest, torch_host_harness
torch_host_harness.run_pinned = lambda args, timeout=300: subprocess.run(
    [str(a) for a in args], capture_output=True, text=True, timeout=timeout)
sys.exit(pytest.main(sys.argv[1:]))
"""


def timed(case: str, pin: bool) -> float:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = [sys.executable, "-m", "pytest"] if pin else [sys.executable, "-c", UNPINNED]
    t0 = time.perf_counter()
    subprocess.run([*run, "tests/test_torch_scan_host.py", "-q", "-p", "no:cacheprovider",
                    "-k", case], cwd=ROOT, env=env, check=True, capture_output=True)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--busy", type=int, default=16, help="spinning processes for the loaded runs")
    ap.add_argument("--case", default=CASE, help="pytest -k expression of the case")
    args = ap.parse_args()
    for pin in (False, True):
        print(f"idle   pinned={pin}: {timed(args.case, pin):.1f} s", flush=True)
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(args.busy)]
    try:
        for pin in (False, True):
            print(f"busy {args.busy} pinned={pin}: {timed(args.case, pin):.1f} s", flush=True)
    finally:
        for proc in spin:
            proc.kill()
            proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
