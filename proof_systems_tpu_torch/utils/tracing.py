"""Checkpoint tracing (internal-tracing/src/lib.rs equivalent).

Counterpart of proof_systems_tpu/utils/tracing.py: a process-global tracer
that timestamps the prover's named checkpoints (the reference's list,
prover.rs:1466-1483), so traces compare across implementations. It is off
until its caller turns it on with `enable`.

A host timestamp measures when the host reached a checkpoint, not when the
card finished the work before it. A caller that wants the card's stages
passes a hook that runs before each timestamp (`torch.cuda.synchronize`),
which costs one synchronisation per checkpoint, so a traced run is not the
run to time as a whole.

`dump_json` exports the checkpoints as the reference does, one JSON line
each with its wall-clock time in microseconds; `intervals` measures on the
monotonic clock.
"""

from __future__ import annotations

import json
import time


class Tracer:
    def __init__(self):
        self.enabled = False
        self.hook = None
        # (name, perf_counter seconds, wall-clock microseconds)
        self.events: list[tuple[str, float, int]] = []

    def enable(self, hook=None) -> None:
        """Record checkpoints from now on; `hook()` runs before each stamp."""
        self.enabled = True
        self.hook = hook
        self.reset()

    def disable(self) -> None:
        self.enabled = False
        self.hook = None

    def checkpoint(self, name: str) -> None:
        if not self.enabled:
            return
        if self.hook is not None:
            self.hook()
        self.events.append((name, time.perf_counter(), int(time.time() * 1e6)))

    def dump_json(self) -> str:
        """One line {"checkpoint": name, "ts_us": wall-clock microseconds}
        for each checkpoint, in order (the reference's exporter)."""
        return "\n".join(json.dumps({"checkpoint": name, "ts_us": ts})
                         for name, _, ts in self.events)

    def reset(self) -> None:
        self.events.clear()

    def intervals(self) -> list[tuple[str, float]]:
        """(checkpoint, seconds from it to the next one), in order."""
        return [(a, tb - ta) for (a, ta, _), (_, tb, _) in zip(self.events, self.events[1:])]


TRACER = Tracer()
checkpoint = TRACER.checkpoint
