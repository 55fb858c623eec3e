"""Sparse multilinear polynomials for the R1CS A/B/C matrices.

Counterpart of ``spartan_tpu/core/sparse_mlpoly.py`` (reference
sparse_mlpoly.rs). Entries are numpy index arrays + one exact value list,
with one Montgomery device copy of the values and int64 permutations for
each access order (by row and by column, with segment boundaries), all
precomputed. Every device operation is

    gather -> H1 field multiply -> exact segment sums

The segment sums replace the JAX package's ``_k_segment_sums_perm``
(``sparse_mlpoly.py:34-47``, a log-depth field-add scan): the products'
16-bit limb columns are prefix-summed in int64 (exact), differenced at the
segment boundaries and reduced mod p, in chunks of at most ``_SEG_CHUNK``
terms whose pieces of one segment are then added mod p. No scatter, no
multiplicity limit, any number of terms.
"""

from __future__ import annotations

import numpy as np
import torch

from spartan_tpu_torch.core.mle import DensePolynomial, EqPolynomial
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.math import next_power_of_two
from spartan_tpu_torch.utils.timer import Timer

fr = F.fr

# terms per exact prefix-sum chunk (int64 column sums stay below 2^40)
_SEG_CHUNK = 1 << 24


def segment_sums(prods, starts, ends):
    """Exact field sums of prods[starts[s]:ends[s]] for each segment s.

    prods [N, 8] canonical Montgomery limbs; starts/ends [S] int64 (sorted
    segments over the prefix array). Returns [S, 8].

    Each chunk of at most ``_SEG_CHUNK`` terms is scanned as one contiguous
    int64 array holding its 16 limb columns one after another (an inner,
    not an outer-dimension, scan); a segment's column sums are differences
    of that scan inside one column, so the columns' running offsets cancel.
    The pieces of a segment that crosses chunk boundaries are added mod p."""
    out = None
    for c0 in range(0, max(prods.shape[0], 1), _SEG_CHUNK):
        n = min(prods.shape[0] - c0, _SEG_CHUNK)
        flat = F._to16(prods[c0:c0 + n]).t().reshape(-1)           # [16 n]
        P = torch.cat((flat.new_zeros(1), torch.cumsum(flat, dim=0)))
        base = torch.arange(16, device=prods.device) * n
        lo = (starts.clamp(c0, c0 + n) - c0).unsqueeze(1) + base
        hi = (ends.clamp(c0, c0 + n) - c0).unsqueeze(1) + base
        part = F.reduce_columns(P[hi] - P[lo], F.FR)
        out = part if out is None else fr.add(out, part)
    return out


def _k_segment_sums_perm(vals, weights, widx, perm, starts, ends):
    """Per-segment sums of val_i * weights[widx_i], in `perm` order."""
    prods = fr.mul(vals[perm], weights[widx[perm]])
    return segment_sums(prods, starts, ends)


def _k_gather_mul3(vals, eq_x, eq_y, rows, cols):
    """sum_i val_i * eq_x[row_i] * eq_y[col_i] (one field reduction)."""
    t = fr.mul(fr.mul(vals, eq_x[rows]), eq_y[cols])
    return fr.reduce_sum(t, axis=0)


def _host_copy(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` kept on the host for copies to ``device``: page-locked for a
    card (so that a copy needs no staging and does not block the host),
    else ``t`` itself."""
    if torch.device(device).type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _device_key(device) -> str:
    """One cache key per card: ``cuda`` (what ``device.resolve`` gives) and
    ``cuda:0`` (a tensor's device) name the same one."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


class SparseMatEntry:
    """One entry of a sparse matrix (sparse_mlpoly.rs:10-32)."""

    __slots__ = ("row", "col", "val")

    def __init__(self, row: int, col: int, val: int):
        self.row = row
        self.col = col
        self.val = val % FR_MOD


class _EntriesView:
    """Lazy sequence of ``SparseMatEntry`` over the array storage (len /
    index / iterate): no per-entry objects unless asked for."""

    def __init__(self, poly: "SparseMatPolynomial"):
        self._p = poly

    def __len__(self):
        return len(self._p.vals)

    def __getitem__(self, i):
        return SparseMatEntry(int(self._p.rows[i]), int(self._p.cols[i]), self._p.vals[i])

    def __iter__(self):
        for r, c, v in zip(self._p.rows.tolist(), self._p.cols.tolist(), self._p.vals):
            yield SparseMatEntry(r, c, v)


class SparseMatPolynomial:
    """MLE of a sparse matrix (sparse_mlpoly.rs:36-181), device-accelerated.

    Built from ``SparseMatEntry``s (the reference's form) or, without any
    per-entry object, from ``rows``/``cols``/``vals`` arrays; ``M`` views
    the arrays as entries."""

    def __init__(self, num_vars_x: int, num_vars_y: int, entries=None, *,
                 rows=None, cols=None, vals=None):
        self.num_vars_x = num_vars_x
        self.num_vars_y = num_vars_y
        if entries is not None:
            rows = [e.row for e in entries]
            cols = [e.col for e in entries]
            vals = [e.val for e in entries]
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.vals = [v % FR_MOD for v in vals]
        self.M = _EntriesView(self)
        self._order_r = np.argsort(self.rows, kind="stable")
        self._order_c = np.argsort(self.cols, kind="stable")
        self._rows_sorted = self.rows[self._order_r]
        self._cols_sorted = self.cols[self._order_c]
        self._dev: dict = {}   # device -> tensors (lazy)
        self._bnd_cache: dict = {}
        # host copies of the two caches, kept across ``release_device``
        self._host: dict = {}
        self._bnd_host: dict = {}

    def __getstate__(self):
        """Pickles the arrays without the device and host copies, which
        belong to this process."""
        state = dict(self.__dict__)
        for k in ("_dev", "_bnd_cache", "_host", "_bnd_host"):
            state[k] = {}
        return state

    @staticmethod
    def from_arrays(num_vars_x: int, num_vars_y: int, rows, cols, vals) -> "SparseMatPolynomial":
        return SparseMatPolynomial(num_vars_x, num_vars_y, rows=rows, cols=cols, vals=vals)

    def _device(self, device):
        """The device copies: on first use the values are encoded and every
        tensor is also kept on the host, so that after ``release_device``
        a copy from the host restores them (no encode)."""
        key = _device_key(device)
        with Timer("matrix_device_copy"):
            if key not in self._dev:
                host = self._host.get(key)
                if host is None:
                    t = lambda a: _host_copy(torch.from_numpy(np.ascontiguousarray(a)), device)
                    host = self._host[key] = {
                        "vals": _host_copy(F.encode_fr(self.vals, device=device), device),
                        "rows": t(self.rows),
                        "cols": t(self.cols),
                        "perm_r": t(self._order_r),
                        "perm_c": t(self._order_c),
                    }
                self._dev[key] = {k: h.to(device, non_blocking=True) for k, h in host.items()}
        return self._dev[key]

    def vals_device(self, device) -> torch.Tensor:
        """The values as [nnz, 8] Montgomery limbs on ``device`` (cached)."""
        return self._device(device)["vals"]

    def release_device(self) -> None:
        """Drop the cached device copies; the next use copies them back
        from the host copies."""
        self._dev.clear()
        self._bnd_cache.clear()

    def num_entries(self) -> int:
        return len(self.vals)

    def get_num_nz_entries(self) -> int:
        """Padded nnz (sparse_mlpoly_full.rs:74), floored at 2 as in the
        JAX package: a 1-entry ops table would give the lookup argument a
        product tree with no layers."""
        return max(2, next_power_of_two(len(self.vals)))

    def _boundaries(self, axis: str, num_segments: int, device):
        key = (axis, num_segments, _device_key(device))
        with Timer("matrix_device_copy"):
            if key not in self._bnd_cache:
                host = self._bnd_host.get(key)
                if host is None:
                    keys = self._rows_sorted if axis == "row" else self._cols_sorted
                    host = self._bnd_host[key] = tuple(
                        _host_copy(torch.from_numpy(
                            np.searchsorted(keys, np.arange(num_segments), side=side)), device)
                        for side in ("left", "right"))
                self._bnd_cache[key] = tuple(h.to(device, non_blocking=True) for h in host)
        return self._bnd_cache[key]

    def multiply_vec_device(self, num_rows: int, z_mont) -> torch.Tensor:
        """M @ z over the field; z_mont [num_cols, 8]; out [num_rows, 8]."""
        if not self.vals:
            return fr.zeros((num_rows,), z_mont.device)
        d = self._device(z_mont.device)
        starts, ends = self._boundaries("row", num_rows, z_mont.device)
        return _k_segment_sums_perm(d["vals"], z_mont, d["cols"], d["perm_r"], starts, ends)

    def multiply_vec(self, num_rows: int, num_cols: int, z: list[int], device=None) -> DensePolynomial:
        assert len(z) == num_cols
        return DensePolynomial(self.multiply_vec_device(num_rows, F.encode_fr(z, device=device)))

    def compute_eval_table_sparse_device(self, evals_mont, num_cols: int) -> torch.Tensor:
        """M^T @ evals: out[col] = sum_rows evals[row] * val (scatter-free)."""
        if not self.vals:
            return fr.zeros((num_cols,), evals_mont.device)
        d = self._device(evals_mont.device)
        starts, ends = self._boundaries("col", num_cols, evals_mont.device)
        return _k_segment_sums_perm(d["vals"], evals_mont, d["rows"], d["perm_c"], starts, ends)

    def compute_eval_table_sparse(self, evals: list[int], num_rows: int, num_cols: int,
                                  device=None) -> list[int]:
        """M^T @ evals as host ints (sparse_mlpoly.rs:145-160), computed on
        ``device`` (or the current one)."""
        assert len(evals) == num_rows
        return F.decode_fr(self.compute_eval_table_sparse_device(
            F.encode_fr(evals, device=device), num_cols))

    def evaluate_with_tables_device(self, eq_rx_mont, eq_ry_mont) -> int:
        if not self.vals:
            return 0
        d = self._device(eq_rx_mont.device)
        out = _k_gather_mul3(d["vals"], eq_rx_mont, eq_ry_mont, d["rows"], d["cols"])
        return F.decode_fr(out.unsqueeze(0))[0]

    def evaluate(self, rx: list[int], ry: list[int], device=None) -> int:
        eq_rx = EqPolynomial(rx).evals_device(device)
        eq_ry = EqPolynomial(ry).evals_device(device)
        return self.evaluate_with_tables_device(eq_rx, eq_ry)

    @staticmethod
    def multi_evaluate(polys, rx: list[int], ry: list[int], device=None) -> list[int]:
        eq_rx = EqPolynomial(rx).evals_device(device)
        eq_ry = EqPolynomial(ry).evals_device(device)
        return [p.evaluate_with_tables_device(eq_rx, eq_ry) for p in polys]
