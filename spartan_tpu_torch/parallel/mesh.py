"""Process-group construction and the table collectives of sharded proving.

Counterpart of ``spartan_tpu/parallel/mesh.py``. The JAX package's
multi-controller model carries over as ``torch.distributed``'s SPMD model:
one process per rank, every process running the same deterministic
host-side prover (the same transcript, the same ``RandomTape`` seed, the same full
tables before sharding) and issuing the same collectives in the same order.
One logical axis partitions every large table (sumcheck tables, product-tree
layers, MSM points and Hyrax rows), so a ``Mesh`` is just the world: its
size, this process's rank and the device its tensors live on.

Device and backend. A rank's tensors live on the CUDA card
``cuda:(local_rank % device_count)`` unless the caller asks for the CPU
(and a rank that wants CUDA and finds none raises, as ``device.resolve``
does). The collectives run on NCCL when the ranks of a host have distinct
cards, on gloo otherwise: CPU ranks, or several ranks sharing one card. gloo
takes few collectives on CUDA tensors, so under gloo with CUDA ranks the
wrappers below copy their (small) operands to the host and back,
explicitly (``Mesh.staged``); the kernels still run on the card.

Layouts. ``shard_table`` gives a rank its block of axis 0 (MSM points,
Hyrax rows); ``shard_strided`` gives it the strided shard of a sumcheck or
product-tree table (element i on rank i mod D at slot i // D,
``sumcheck_sharded.py``). ``gather_table`` and ``gather_unstride`` are
their inverses: all-gathers that hand a table back to every rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from spartan_tpu_torch.ops.limbs import NUM_LIMBS

SHARD_AXIS = "shard"

# seconds a collective may wait for the other ranks before it raises
TIMEOUT_S = 1800


@dataclass
class Mesh:
    """The world of ranks that shard one prove."""

    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> bool:
        """Whether collectives go through host copies (gloo, CUDA ranks)."""
        return self.backend != "nccl" and self.device.type == "cuda"


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def rank_device(device=None, local_rank: int = 0) -> torch.device:
    """The device of a rank: ``None`` or an index-less "cuda" means the card
    ``cuda:(local_rank % device_count)`` (raises without CUDA); "cpu" the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def default_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when each rank of the host has a card of its own, else gloo."""
    if device.type == "cuda" and dist.is_nccl_available() and \
            local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, backend: str | None = None,
                     device=None) -> None:
    """Join the process group of a sharded prove; a no-op when one exists.

    Without arguments it reads ``env://`` (what ``torchrun`` sets: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE);
    otherwise pass ``init_method`` (e.g. ``file:///tmp/dir/rendezvous``),
    ``rank`` and ``world_size``. The backend follows ``default_backend``
    for the rank's device unless given."""
    if dist.is_initialized():
        return
    if rank is None or world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("init_distributed: pass rank= and world_size= (and "
                               "init_method=), or run under torchrun")
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, _local_rank(rank))
    if backend is None:
        local_ws = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = default_backend(dev, local_ws)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=TIMEOUT_S))


def make_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the current process group (``init_distributed`` first).

    ``num_devices``, if given, must be the world size; ``device`` as in
    ``rank_device``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed process group; call "
                           "parallel.init_distributed() first (or run under torchrun)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"make_mesh: {num_devices} devices asked, the world has {size} ranks")
    dev = rank_device(device, _local_rank(rank))
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("make_mesh: an NCCL group needs CUDA ranks")
    return Mesh(size, rank, dev, backend)


def check_device(mesh: Mesh, device) -> None:
    """Raise unless ``device`` (e.g. the generators') is the mesh's."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != mesh.device:
        raise ValueError(f"mesh device {mesh.device} differs from the generators' {dev}")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x stacked [D, *x.shape], on x's device."""
    src = x.contiguous()
    if mesh.staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src)
    return torch.stack(parts).to(x.device)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The integer sum of every rank's x, on x's device."""
    buf = x.cpu() if mesh.staged else x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(x.device)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def shard_table(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of axis 0 (a view; the length must divide)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_table: {n} rows over {mesh.size} ranks")
    m = n // mesh.size
    return x[mesh.rank * m:(mesh.rank + 1) * m]


def shard_strided(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's strided shard [N/D, 8] of a table [N, 8]: entries
    rank, rank + D, rank + 2D, ... (a contiguous copy, so the caller may
    drop the full table)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_strided: {n} entries over {mesh.size} ranks")
    return x.view(n // mesh.size, mesh.size, NUM_LIMBS)[:, mesh.rank].contiguous()


def replicate(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A value every rank holds whole (the same on each): on the mesh's device."""
    return x.to(mesh.device)


def gather_table(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``shard_table``: the ranks' blocks concatenated."""
    return all_gather(mesh, x).flatten(0, 1)


def gather_unstride(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``shard_strided``: the ranks' shards [m, 8] -> the
    natural-order table [D * m, 8] on every rank."""
    from spartan_tpu_torch.parallel.sumcheck_sharded import from_strided

    return from_strided(all_gather(mesh, x))
