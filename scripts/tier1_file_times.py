"""Per-file wall time and peak resident memory of a pytest run.

As a pytest plugin it samples each process's resident set every 0.25 s and
writes, when the process ends, one JSON file a process into
$TIER1_TIMES_DIR: test file -> {"seconds", "peak_rss"}. A file's seconds
run from its first test's start to the next file's (its module fixtures'
set-up and tear-down included); its peak is the process's largest resident
set while it ran, which includes what earlier files of that worker kept.

    mkdir -p /tmp/t1 && TIER1_TIMES_DIR=/tmp/t1 PYTHONPATH=scripts \\
        python -m pytest tests/ -n 6 --dist loadfile -p tier1_file_times ...
    python scripts/tier1_file_times.py /tmp/t1 [/tmp/t1_other]

With two directories the table compares them file by file.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

_state = {"file": None, "t0": None, "peak": 0}
_rows: dict[str, dict] = {}
_lock = threading.Lock()


def _rss() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) * 1024
    return 0


def _sample() -> None:
    while True:
        r = _rss()
        with _lock:
            _state["peak"] = max(_state["peak"], r)
        time.sleep(0.25)


def _close() -> None:
    f = _state["file"]
    if f is not None:
        _rows[f] = dict(seconds=time.time() - _state["t0"], peak_rss=_state["peak"])


def pytest_configure(config) -> None:
    # an xdist controller sees every worker's tests start; only a process
    # that runs tests keeps times
    _state["runs_tests"] = hasattr(config, "workerinput") or not getattr(
        config.option, "numprocesses", None)
    threading.Thread(target=_sample, daemon=True).start()


def pytest_runtest_logstart(nodeid, location) -> None:
    f = nodeid.split("::")[0]
    with _lock:
        if f != _state["file"]:
            _close()
            _state.update(file=f, t0=time.time(), peak=_rss())


def pytest_unconfigure(config) -> None:
    with _lock:
        _close()
    out = os.environ.get("TIER1_TIMES_DIR")
    if out and _rows and _state.get("runs_tests"):
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        with open(os.path.join(out, f"{worker}_{os.getpid()}.json"), "w") as fh:
            json.dump(_rows, fh)


def load(path: str) -> dict[str, dict]:
    rows: dict[str, dict] = {}
    names = sorted(os.listdir(path))
    workers = any(n.startswith("gw") for n in names)
    for name in names:
        if name.endswith(".json") and not (workers and name.startswith("main")):
            with open(os.path.join(path, name)) as fh:
                rows.update(json.load(fh))
    return rows


def main(argv: list[str]) -> int:
    runs = [load(p) for p in argv[1:3]]
    if not runs:
        print(__doc__)
        return 2
    files = sorted(set().union(*runs), key=lambda f: -max(r.get(f, {}).get("seconds", 0)
                                                         for r in runs))
    head = " | ".join(f"{p}: s | GiB" for p in argv[1:3])
    print(f"| file | {head} |")
    print("|---|" + "---|---|" * len(runs))
    for f in files:
        cells = []
        for r in runs:
            v = r.get(f)
            cells.append("— | —" if v is None else f"{v['seconds']:.1f} | {v['peak_rss'] / 2**30:.2f}")
        print(f"| `{f}` | " + " | ".join(cells) + " |")
    sums = " | ".join(f"{sum(v['seconds'] for v in r.values()):.1f} | " for r in runs)
    print(f"| serial sum | {sums}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
