"""Dense multilinear polynomials + eq polynomial on the device.

Counterpart of ``spartan_tpu/core/mle.py`` (the reference's
hyrax.rs:156-403): evaluation tables are [N, 8] Montgomery limb tensors;
eq-table builds, matrix-bound products and dot products compose the H1
field kernel with exact plain-torch sums, and the top-variable fold is
kernel S1. Scalars crossing the host boundary (transcript values, claimed
evaluations) are Python ints. Tables of at most ``hostpath.HOST_N`` entries
are evaluated on the host.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import sumcheck_kernels as SK
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.math import log_2, next_power_of_two, pow2

fr = F.fr

# [L, R, 8] product transient budget for DensePolynomial.bound (elements);
# module-level so tests can shrink it to exercise the chunk boundaries
BOUND_BUDGET = 1 << 24


def k_eq_evals(r, ell: int):
    """eq(r, x) table over x in {0,1}^ell; r [ell, 8]; out [2^ell, 8].

    Index convention matches the reference (hyrax.rs:355-369): bit for r[0]
    is the MOST significant bit of the table index.
    """
    table = fr.one((1,), r.device)
    for j in range(ell):
        hi = fr.mul(table, r[j])        # bit_j = 1
        lo = fr.sub(table, hi)          # bit_j = 0  (table * (1 - r_j))
        table = torch.stack((lo, hi), dim=1).reshape(-1, F.NUM_LIMBS)
    return table


def k_dot(a, b):
    """<a, b> over the field, [N, 8] x [N, 8] -> [8]."""
    return fr.reduce_sum(fr.mul(a, b), axis=0)


def k_bound_matrix(Z, L, L_size: int, R_size: int):
    """LZ[j] = sum_i L[i] * Z[i*R+j]  (hyrax.rs:311-324), out [R, 8]."""
    M = Z.reshape(L_size, R_size, F.NUM_LIMBS)
    return fr.reduce_sum(fr.mul(L.unsqueeze(1), M), axis=0)


def bound_rows(Z, L, L_size: int, R_size: int):
    """``k_bound_matrix`` in chunks of rows when the [L, R, 8] product
    transient would exceed ``BOUND_BUDGET`` elements."""
    if L_size * R_size <= BOUND_BUDGET:
        return k_bound_matrix(Z, L, L_size, R_size)
    rows_per = max(1, BOUND_BUDGET // R_size)
    acc = None
    for start in range(0, L_size, rows_per):
        stop = min(start + rows_per, L_size)
        part = k_bound_matrix(Z[start * R_size: stop * R_size], L[start:stop],
                              stop - start, R_size)
        acc = part if acc is None else fr.add(acc, part)
    return acc


def encode_scalar(x: int, device=None):
    """One host int -> [8] Montgomery limbs."""
    return F.encode_fr([x], device=device)[0]


def decode_scalar(arr) -> int:
    return F.decode_fr(arr.reshape(-1, F.NUM_LIMBS))[0]


def first_rows(arrs):
    """[K, 8]: row 0 of each table (the claims a sumcheck ends with)."""
    return torch.stack([a[0] for a in arrs], dim=0)


def decode_tables(arrs) -> list[list[int]]:
    """Decode K equal-length [n, 8] tables with one device->host copy."""
    if not arrs:
        return []
    n = arrs[0].shape[0]
    vals = F.decode_fr(torch.cat(list(arrs), dim=0))
    return [vals[i * n:(i + 1) * n] for i in range(len(arrs))]


class DensePolynomial:
    """MLE by its evaluation table, device-resident (hyrax.rs:156-324)."""

    def __init__(self, Z):
        """Z: [N, 8] Montgomery limb tensor."""
        self.Z = Z
        self.len = Z.shape[0]
        self.num_vars = log_2(self.len) if self.len > 0 else 0

    @staticmethod
    def from_ints(vals: list[int], device=None) -> "DensePolynomial":
        return DensePolynomial(F.encode_fr(vals, device=device))

    @staticmethod
    def from_usize(vals, device=None) -> "DensePolynomial":
        """Small non-negative ints (numpy array or list) -> MLE, encoded on
        the device (no Python ints)."""
        return DensePolynomial(F.encode_small_uints(vals, device=device))

    def to_ints(self) -> list[int]:
        return F.decode_fr(self.Z)

    def clone(self) -> "DensePolynomial":
        return DensePolynomial(self.Z)

    def split(self, idx: int):
        assert idx < self.len
        return DensePolynomial(self.Z[:idx]), DensePolynomial(self.Z[idx: 2 * idx])

    def extend(self, other: "DensePolynomial") -> None:
        assert other.len == self.len
        self.rebind(torch.cat((self.Z, other.Z), dim=0))

    @staticmethod
    def merge(polys) -> "DensePolynomial":
        """Concatenate tables, zero-pad to a power of two (hyrax.rs:237-247)."""
        Zs = [p.Z for p in polys]
        total = sum(z.shape[0] for z in Zs)
        pad = next_power_of_two(total) - total
        if pad:
            Zs.append(torch.zeros((pad, F.NUM_LIMBS), dtype=torch.int32, device=Zs[0].device))
        return DensePolynomial(torch.cat(Zs, dim=0))

    def bound_poly_var_top(self, r) -> None:
        """Bind the top variable to r (an int or [8] limbs): kernel S1."""
        r_dev = r if isinstance(r, torch.Tensor) else encode_scalar(r, self.Z.device)
        (Z,) = SK.fold([self.Z], r_dev)
        self.rebind(Z)

    def bound_poly_var_bot(self, r) -> None:
        """Bind the bottom variable: Z'[i] = Z[2i] + r (Z[2i+1] - Z[2i])
        (hyrax.rs:206-214)."""
        r_dev = r if isinstance(r, torch.Tensor) else encode_scalar(r, self.Z.device)
        ev, od = self.Z[0::2], self.Z[1::2]
        self.rebind(fr.add(ev, fr.mul(r_dev, fr.sub(od, ev))))

    def rebind(self, Z) -> None:
        """Adopt an externally-folded table (sumcheck round steps)."""
        self.Z = Z
        self.len = Z.shape[0]
        self.num_vars = log_2(self.len) if self.len > 0 else 0

    def evaluate(self, r: list[int]) -> int:
        assert len(r) == self.num_vars
        if self.len <= HP.HOST_N:
            return HP.evaluate_mle(self.to_ints(), r)
        chis = EqPolynomial(r).evals_device(self.Z.device)
        return decode_scalar(k_dot(self.Z, chis))

    def evaluate_device(self, r_dev):
        """r_dev [ell, 8] Montgomery -> [8] Montgomery (stays on the device)."""
        return k_dot(self.Z, k_eq_evals(r_dev, self.num_vars))

    def bound(self, L_dev, L_size: int, R_size: int, mesh=None):
        """L*Z matrix product, returns [R, 8]; chunked over the L axis when
        the [L, R, 8] product transient would be large. With ``mesh`` the
        rows are sharded over the ranks (the same values)."""
        if mesh is not None and mesh.size > 1 and L_size % mesh.size == 0 and \
                L_size >= mesh.size:
            from spartan_tpu_torch.parallel.sumcheck_sharded import bound_sharded

            return bound_sharded(mesh, self.Z, L_dev, L_size, R_size)
        return bound_rows(self.Z, L_dev, L_size, R_size)

    def item(self, i: int) -> int:
        return decode_scalar(self.Z[i])

    def first(self) -> int:
        """Z[0] as host int — the post-sumcheck claim readout."""
        return self.item(0)


def batch_evaluate(polys: list[DensePolynomial], r: list[int]) -> list[int]:
    """Evaluate equal-length MLEs at one point, sharing one eq table; one
    dot product per table, so no [K, N] stack materializes."""
    if not polys:
        return []
    chis = EqPolynomial(r).evals_device(polys[0].Z.device)
    return F.decode_fr(torch.stack([k_dot(p.Z, chis) for p in polys], dim=0))


class EqPolynomial:
    """eq(r, .) utilities (hyrax.rs:337-383). r is host ints."""

    def __init__(self, r: list[int]):
        self.r = list(r)

    def evaluate(self, rx: list[int]) -> int:
        assert len(rx) == len(self.r)
        acc = 1
        for a, b in zip(self.r, rx):
            acc = acc * (a * b + (1 - a) * (1 - b)) % FR_MOD
        return acc % FR_MOD

    def evals_device(self, device=None):
        if not self.r:
            return fr.one((1,), device)
        if (1 << len(self.r)) <= HP.HOST_N:
            return F.encode_fr(HP.eq_evals(self.r), device=device)
        return k_eq_evals(F.encode_fr(self.r, device=device), len(self.r))

    def evals(self, device=None) -> list[int]:
        """The eq table as host ints: the host table up to ``HP.HOST_N``
        entries, else ``k_eq_evals`` on ``device`` (or the current one)."""
        return F.decode_fr(self.evals_device(device))

    @staticmethod
    def compute_factored_lens(ell: int) -> tuple[int, int]:
        return ell // 2, ell - ell // 2

    def compute_factored_evals(self, device=None):
        """(L table, R table) as device tensors (hyrax.rs:375-383)."""
        left, _ = EqPolynomial.compute_factored_lens(len(self.r))
        return (EqPolynomial(self.r[:left]).evals_device(device),
                EqPolynomial(self.r[left:]).evals_device(device))


class IdentityPolynomial:
    """MLE of the index function (hyrax.rs:387-403)."""

    def __init__(self, size_point: int):
        self.size_point = size_point

    def evaluate(self, r: list[int]) -> int:
        n = len(r)
        assert n == self.size_point
        return sum(pow2(n - i - 1) * r[i] for i in range(n)) % FR_MOD


def compute_dotproduct(a: list[int], b: list[int]) -> int:
    assert len(a) == len(b)
    return sum(x * y for x, y in zip(a, b)) % FR_MOD

