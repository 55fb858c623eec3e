"""Sharded proving over ``torch.distributed``: one process per rank.

Counterpart of ``spartan_tpu/parallel/`` (same names). ``init_distributed``
joins (or starts, under ``torchrun``) a process group; ``make_mesh`` wraps it;
the entry points ``NIZK.prove``, ``SNARK.encode`` and ``SNARK.prove`` take
``mesh=`` and then shard their large tables over the ranks, with proofs
byte-identical to the single-device ones. ``launch.spawn`` starts a world of
ranks on one host.
"""

from spartan_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    Mesh,
    gather_table,
    gather_unstride,
    init_distributed,
    make_mesh,
    replicate,
    shard_strided,
    shard_table,
)
from spartan_tpu_torch.parallel.msm_sharded import commit_rows_sharded, msm_sharded
from spartan_tpu_torch.parallel.sumcheck_sharded import (
    bound_sharded,
    from_strided,
    make_cubic_round,
    psum_field,
    to_strided,
)

__all__ = [
    "SHARD_AXIS",
    "Mesh",
    "make_mesh",
    "init_distributed",
    "gather_table",
    "gather_unstride",
    "replicate",
    "shard_table",
    "shard_strided",
    "msm_sharded",
    "commit_rows_sharded",
    "bound_sharded",
    "make_cubic_round",
    "to_strided",
    "from_strided",
    "psum_field",
]
