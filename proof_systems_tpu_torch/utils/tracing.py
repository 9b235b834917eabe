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
"""

from __future__ import annotations

import time


class Tracer:
    def __init__(self):
        self.enabled = False
        self.hook = None
        self.events: list[tuple[str, float]] = []

    def enable(self, hook=None) -> None:
        """Record checkpoints from now on; `hook()` runs before each stamp."""
        self.enabled = True
        self.hook = hook
        self.events.clear()

    def disable(self) -> None:
        self.enabled = False
        self.hook = None

    def checkpoint(self, name: str) -> None:
        if not self.enabled:
            return
        if self.hook is not None:
            self.hook()
        self.events.append((name, time.perf_counter()))

    def intervals(self) -> list[tuple[str, float]]:
        """(checkpoint, seconds from it to the next one), in order."""
        return [(a, tb - ta) for (a, ta), (_, tb) in zip(self.events, self.events[1:])]


TRACER = Tracer()
checkpoint = TRACER.checkpoint
