"""The port's checkpoint tracer (utils/tracing.py) against the reference's
(proof_systems_tpu/utils/tracing.py): dump_json gives the same JSON lines,
keys, order and types, for the same checkpoint names, and reset empties
it."""

import json
import time

from proof_systems_tpu.utils.tracing import Tracer as RefTracer
from proof_systems_tpu_torch.utils.tracing import Tracer

# the first prover checkpoints of the reference list (prover.rs:1466-1483)
NAMES = ["create_recursive", "pad_witness", "commit_to_witness_columns",
         "z_permutation_aggregation_polynomial", "eval_witness_polynomials_over_domains"]


def _lines(tracer) -> list[dict]:
    text = tracer.dump_json()
    return [json.loads(line) for line in text.splitlines()] if text else []


def test_dump_json_matches_reference():
    ref = RefTracer()
    ref.enabled = True
    ours = Tracer()
    ours.enable()
    before = int(time.time() * 1e6)
    for name in NAMES:
        ref.checkpoint(name)
        ours.checkpoint(name)
    after = int(time.time() * 1e6)
    want, got = _lines(ref), _lines(ours)
    assert [list(d) for d in got] == [list(d) for d in want] == [["checkpoint", "ts_us"]] * 5
    assert [d["checkpoint"] for d in got] == [d["checkpoint"] for d in want] == NAMES
    for g, w in zip(got, want):
        assert type(g["ts_us"]) is type(w["ts_us"]) is int
        assert before <= g["ts_us"] <= after and before <= w["ts_us"] <= after
    stamps = [d["ts_us"] for d in got]
    assert stamps == sorted(stamps)
    assert [name for name, _ in ours.intervals()] == NAMES[:-1]


def test_reset_and_disabled():
    ref, ours = RefTracer(), Tracer()
    ref.enabled = True
    ours.enable()
    for t in (ref, ours):
        t.checkpoint("create_recursive")
        t.reset()
        assert t.dump_json() == "" and t.events == []
    ours.checkpoint("pad_witness")
    ours.disable()
    ours.checkpoint("commit_to_witness_columns")  # off: not recorded
    assert [d["checkpoint"] for d in _lines(ours)] == ["pad_witness"]
    ours.enable()  # enabling starts a fresh trace
    assert ours.dump_json() == "" and ours.intervals() == []
