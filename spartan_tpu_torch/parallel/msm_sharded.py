"""Multi-rank Pippenger MSM: points sharded, window sums reduced by the curve law.

Counterpart of ``spartan_tpu/parallel/msm_sharded.py``. Each rank runs the
bucket method (H3 + H4, ``ops/msm.py`` ``window_sums``, as the single-device
MSM does) on its block of points with the same windows; the
[W] per-window projective partials (a few KB) are all-gathered, added across
ranks with complete additions (``ops/msm.py`` ``reduce_points``) and
combined by H2's Horner ladder, replicated on every rank. Group elements
are never summed as integers.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.config import DEFAULT
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import msm as MSM
from spartan_tpu_torch.ops.limbs import NUM_LIMBS
from spartan_tpu_torch.parallel.mesh import Mesh, all_gather


def commit_rows_sharded(mesh: Mesh, Z_mont, blinds_mont, gens):
    """Row-parallel Hyrax matrix commit: rank r commits rows
    [r * L/D, (r+1) * L/D) of Z [L, R, 8] (Montgomery; L padded with zero
    rows to a multiple of D) with ``commitments.commit_rows``, and the [L]
    points are all-gathered: every rank gets the projective points of the
    unsharded commit's affine values."""
    from spartan_tpu_torch.core.commitments import commit_rows

    D = mesh.size
    L, R = Z_mont.shape[0], Z_mont.shape[1]
    rows = -(-L // D)
    lo, hi = min(mesh.rank * rows, L), min((mesh.rank + 1) * rows, L)
    Zb, bb = Z_mont[lo:hi], blinds_mont[lo:hi]
    if hi - lo < rows:
        pad = rows - (hi - lo)
        Zb = torch.cat((Zb, Z_mont.new_zeros((pad, R, NUM_LIMBS))), dim=0)
        bb = torch.cat((bb, blinds_mont.new_zeros((pad, NUM_LIMBS))), dim=0)
    pts = commit_rows(Zb, bb, gens)
    return tuple(all_gather(mesh, a).flatten(0, 1)[:L] for a in pts)


def msm_sharded(mesh: Mesh, points, scalars, c: int | None = None):
    """MSM over the mesh. ``points``: this rank's block of the affine
    (x, y, inf) generators; ``scalars``: the matching canonical limbs
    [n_local, 8]. Returns the replicated projective point of the whole MSM."""
    n = scalars.shape[0]
    if c is None:
        c = DEFAULT.msm_window or MSM.choose_window(n)
    digits = MSM.window_digits(scalars, c)                       # [n, W]
    dig = digits.t().contiguous()                                # [W, n]
    del digits
    part = MSM.window_sums(points, dig, c)                       # [W]
    wins = MSM.reduce_points(tuple(all_gather(mesh, a) for a in part), axis=0)
    acc = CU.horner(tuple(w.flip(0).unsqueeze(1) for w in wins), c)           # [1]
    return tuple(a[0] for a in acc)
