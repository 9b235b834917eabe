"""Run a compiled host harness of tests/cuda_host/ on one CPU.

The harnesses emulate a warp (or a block) as host threads that meet at a
std::barrier at every shuffle. Spread over a loaded machine, each barrier
waits for every thread to be scheduled somewhere; on one CPU a barrier
costs a few context switches. Each pytest-xdist worker takes its own CPU of
the process's affinity set (the main process takes the first)."""

import os
import subprocess


def _cpu() -> int:
    cpus = sorted(os.sched_getaffinity(0))
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    return cpus[int(worker.lstrip("gw") or 0) % len(cpus)]


def run_pinned(args, timeout: int = 300) -> subprocess.CompletedProcess:
    """subprocess.run(args) with its threads on one CPU, output captured."""
    cpu = _cpu()
    return subprocess.run([str(a) for a in args], capture_output=True, text=True, timeout=timeout,
                          preexec_fn=lambda: os.sched_setaffinity(0, {cpu}))
