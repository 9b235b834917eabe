"""The arrabbiata CLI (folding/cli.py) on the CPU against the JAX
package's (folding/cli.py): `execute square -n 2 --srs-size 8 --no-decider`
prints the same stderr lines (z and digest a step) and the same JSON line
but for the times, and both refuse the same arguments."""

import json

import pytest
import torch

from proof_systems_tpu.folding import cli as jcli
from proof_systems_tpu_torch.folding import cli

# The plain versions' curve arithmetic of the commits dominates; two threads halve
# it, and a test process per core would oversubscribe the machine at more
torch.set_num_threads(2)

CPU = torch.device("cpu")


def test_cli_lines_equal_jax(capsys, tmp_path, monkeypatch):
    """The port's CLI on the CPU against the JAX package's: the per-step
    stderr lines but for the time, and the JSON line but for the times."""
    monkeypatch.setattr("proof_systems_tpu_torch.poly_commitment.srs.DEFAULT_CACHE_DIR",
                        tmp_path)
    outs = []
    for run in (lambda: cli.execute("square", 2, 8, decide=False, device=CPU),
                lambda: jcli.execute("square", 2, 8, decide=False)):
        out = run()
        captured = capsys.readouterr()
        line = json.loads(captured.out.strip().splitlines()[-1])
        assert line == out and line["metric"] == "arrabbiata_fold_throughput"
        steps = [ln.split(" fully proven in ")[0] + ln.split(" us ")[1]
                 for ln in captured.err.splitlines() if ln.startswith("Iteration ")]
        assert len(steps) == 2
        outs.append(({k: v for k, v in line.items() if k not in ("total_s", "folds_per_s")},
                     steps))
    assert outs[0] == outs[1]
    assert outs[0][0] == {"metric": "arrabbiata_fold_throughput", "zkapp": "square",
                          "iterations": 2, "rows_per_instance": 256, "decider_ok": None}


def test_cli_refuses_what_the_jax_cli_refuses():
    for ex in (cli.execute, jcli.execute):
        with pytest.raises(SystemExit, match="unknown zkapp"):
            ex("cube", 1, 8, decide=False)
        with pytest.raises(SystemExit, match="too small"):
            ex("square", 1, 7, decide=False)
