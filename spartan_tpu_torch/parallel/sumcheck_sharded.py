"""Sequence-parallel sumcheck rounds over the ranks of a mesh.

Counterpart of ``spartan_tpu/parallel/sumcheck_sharded.py``. The
evaluation tables are sharded in a *strided* layout: element i of an
N-entry table lives on rank i mod D at local slot i // D. The top-variable
fold pairs (i, i + N/2) then land on one rank at local slots (k, k + N/2D),
so a rank's shard folds and evaluates with the single-device round kernels
unchanged (S1 fold, S2 batched product step, S3 additive step, S4 quad
step, H1 for the product-tree level Z[i] * Z[i + n/2]) until the table
shrinks below the rank count.

A round's evaluations are the ranks' partial field sums added exactly:
``psum_field`` widens the canonical limbs to 16-bit int64 columns, sums
them across ranks with one ``all_reduce`` and normalises the columns mod p
(exact for sums of up to 2^24 canonical elements). Every partial sum of a
round goes into that one collective. Field sums are order-independent mod
p, so every rank ends each round with the single-device values.

The ``make_*`` functions keep the JAX package's names, but where those
build a ``shard_map``-ped function to call later, these run the round on
this rank's shards at once and take the mesh as their first argument:
JAX's ``make_cubic_step(mesh)(T, A, B, C, r)`` is
``make_cubic_step(mesh, T, A, B, C, r)`` here. The sumcheck provers call
them (``core/sumcheck.py`` ``_MeshTables``, ``_BatchedMeshTables``); the
tables passed are the rank's contiguous strided shards.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import sumcheck_kernels as SK
from spartan_tpu_torch.ops.limbs import NUM_LIMBS
from spartan_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

fr = F.fr


def to_strided(x: torch.Tensor, num_devices: int) -> torch.Tensor:
    """[N, 8] natural order -> [D, N/D, 8]: row d is rank d's shard."""
    n = x.shape[0]
    assert n % num_devices == 0
    return x.reshape(n // num_devices, num_devices, NUM_LIMBS).transpose(0, 1).contiguous()


def from_strided(x: torch.Tensor) -> torch.Tensor:
    """[D, N/D, 8] -> [N, 8] natural order."""
    d, m = x.shape[0], x.shape[1]
    return x.transpose(0, 1).reshape(d * m, NUM_LIMBS)


def psum_field(mesh: Mesh, x_canon: torch.Tensor) -> torch.Tensor:
    """Exact field sum across ranks of canonical elements [..., 8]: one
    integer all-reduce of their 16-bit columns, then one normalisation.
    Callers with several partial sums stack them into one call."""
    return F.reduce_columns(all_reduce_sum(mesh, F._to16(x_canon)), F.FR)


def make_cubic_evals(mesh: Mesh, T, A, B, C) -> torch.Tensor:
    """(e0, e2, e3) [3, 8] of sum T * (A*B - C) over the shards (S3)."""
    return psum_field(mesh, SK.additive_evals(T, A, B, C))


def make_quad_evals(mesh: Mesh, A, B) -> torch.Tensor:
    """(e0, e2) [2, 8] of sum A * B over the shards (S4)."""
    return psum_field(mesh, SK.quad_evals(A, B))


def make_fold(mesh: Mesh, tables, r) -> list:
    """The shards folded by r (S1), strided layout kept: a fold pairs two
    slots of one rank, so it needs no collective."""
    return SK.fold(tables, r)


def make_cubic_step(mesh: Mesh, T, A, B, C, r) -> tuple:
    """(T', A', B', C', evals [3, 8]): fold by r, then the next round's
    evaluations, in one S3 launch a rank and one psum."""
    *folded, ev = SK.additive_step(T, A, B, C, r)
    return (*folded, psum_field(mesh, ev))


def make_quad_step(mesh: Mesh, A, B, r) -> tuple:
    """(A', B', evals [2, 8]): one S4 launch a rank and one psum."""
    A2, B2, ev = SK.quad_step(A, B, r)
    return A2, B2, psum_field(mesh, ev)


def make_cubic_round(mesh: Mesh, T, A, B, C, r) -> tuple:
    """(e0, e2, e3, T', A', B', C'): this round's evaluations (one psum),
    then the shards folded by r."""
    ev = make_cubic_evals(mesh, T, A, B, C)
    return (ev[0], ev[1], ev[2], *make_fold(mesh, [T, A, B, C], r))


def make_tree_level(mesh: Mesh, z: torch.Tensor) -> torch.Tensor:
    """A product-tree level on a strided shard: prod[i] = Z[i] * Z[i + n/2]
    has both factors on the rank (H1), so a tree is built with no
    communication."""
    half = z.shape[0] // 2
    return fr.mul(z[:half], z[half:2 * half])


def make_batched_evals(mesh: Mesh, nP: int, TA, TB, TC, Cp) -> torch.Tensor:
    """[3I, 8] round evaluations of a batched product sumcheck over the
    shards: the first nP instances share the eq table Cp, the rest have
    their own C in TC (one S2 launch a rank, one psum)."""
    return psum_field(mesh, SK.prod_evals(TA, TB, [Cp] * nP + list(TC)))


def make_batched_step(mesh: Mesh, nP: int, TA, TB, TC, Cp, r) -> tuple:
    """(TA', TB', TC', Cp', evals [3I, 8]): fold every shard by r (the
    shared Cp once, by S1), then the next round's evaluations (S2)."""
    nS = len(TC)
    (Cp,) = SK.fold([Cp], r)
    TA, TB, Cs, ev = SK.prod_step(TA, TB, [Cp] * nP + list(TC), r,
                                  [False] * nP + [True] * nS)
    return TA, TB, Cs[nP:], Cp, psum_field(mesh, ev)


def make_batched_fold(mesh: Mesh, TA, TB, TC, Cp, r) -> tuple:
    """(TA', TB', TC', Cp'): the shards folded by r (S1), layout kept."""
    I = len(TA)
    out = SK.fold(list(TA) + list(TB) + [Cp] + list(TC), r)
    return out[:I], out[I:2 * I], out[2 * I + 1:], out[2 * I]


def bound_sharded(mesh: Mesh, Z: torch.Tensor, L_dev: torch.Tensor, L_size: int,
                  R_size: int) -> torch.Tensor:
    """LZ[j] = sum_i L[i] * Z[i*R + j] with the L (row) axis sharded: each
    rank reduces its block of L_size / D rows of the (replicated) table and
    one psum joins them; the single-device ``k_bound_matrix`` values."""
    from spartan_tpu_torch.core.mle import bound_rows

    rows = L_size // mesh.size
    lo = mesh.rank * rows
    part = bound_rows(Z[lo * R_size:(lo + rows) * R_size], L_dev[lo:lo + rows], rows, R_size)
    return psum_field(mesh, part)
