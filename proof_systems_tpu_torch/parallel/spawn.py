"""Start one process per device, each a rank of the default process group.

Every rank pins torch to one intra-op thread, sets LOCAL_RANK (its card
under NCCL), initialises the group from a `file://` store in a fresh
temporary directory (no network), runs `fn(mesh)` with the mesh of
parallel/auto.py, pickles what it returns, and destroys the group. `fn`
must be a module-level function of a module that the spawned interpreter
can import without side effects: the children re-import it.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path

import torch

from ..runtime import resolve_device


def backend_for(device) -> str:
    """A world's backend: NCCL on cards (the default), gloo when
    device="cpu"."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _rank_main(rank: int, world: int, backend: str, root: str, fn) -> None:
    import torch.distributed as dist

    from .auto import data_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{root}/store", rank=rank,
                            world_size=world)
    try:
        out = fn(data_mesh())
        with open(Path(root) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


class Ranks:
    """`world` ranks of `fn(mesh)`, started at construction;
    results() waits for them and returns each rank's value in rank order.
    A rank that raises makes results() raise."""

    def __init__(self, fn, world: int, device=None):
        import torch.multiprocessing as mp

        backend = backend_for(device)
        if backend == "nccl" and torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks need {world} CUDA devices, "
                               f"{torch.cuda.device_count()} present")
        self.world = world
        self.root = tempfile.mkdtemp(prefix="pst_mesh_")
        self.ctx = mp.start_processes(_rank_main, args=(world, backend, self.root, fn),
                                      nprocs=world, join=False, start_method="spawn")

    def results(self, timeout: float | None = None) -> list:
        """Each rank's value; past `timeout` seconds the ranks are killed
        and TimeoutError raised (a rank stuck in a collective never
        returns)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not self.ctx.join(timeout=1):
                if deadline is not None and time.monotonic() > deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    raise TimeoutError(f"{self.world} ranks still running after {timeout} s")
            out = []
            for r in range(self.world):
                with open(Path(self.root) / f"rank{r}.pkl", "rb") as fh:
                    out.append(pickle.load(fh))
            return out
        finally:
            shutil.rmtree(self.root, ignore_errors=True)
