"""Start a world of ranks on this host and collect what each returns.

``spawn(fn, world_size, *args)`` starts ``world_size`` processes with the
``spawn`` start method (never ``fork``: the caller may hold CUDA state),
joins them in one process group through a ``file://`` rendezvous in a
temporary directory (no network), and runs ``fn(mesh, *args)`` in each.
``fn`` must be a module-level function of a module that imports without
JAX. Each rank's return value comes back pickled through the same
directory; the list is in rank order. If a rank raises or dies, the others
are stopped and ``spawn`` raises: no rank's failure is ever skipped.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spartan_tpu_torch.parallel.mesh import init_distributed, make_mesh


def _rank_main(rank: int, fn, world_size: int, tmp: str, device, backend, threads,
               args) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_distributed(init_method="file://" + os.path.join(tmp, "rendezvous"), rank=rank,
                     world_size=world_size, backend=backend, device=device)
    try:
        out = fn(make_mesh(world_size, device=device), *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".part", path)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device=None, backend: str | None = None,
          threads: int | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` new ranks; their results
    in rank order. ``device``: as ``mesh.rank_device`` (the card unless
    "cpu"); ``backend``: as ``mesh.default_backend`` unless given;
    ``threads``: torch threads per rank."""
    with tempfile.TemporaryDirectory(prefix="spartan_mesh_") as tmp:
        mp.spawn(_rank_main, args=(fn, world_size, tmp, device, backend, threads, args),
                 nprocs=world_size, join=True)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
