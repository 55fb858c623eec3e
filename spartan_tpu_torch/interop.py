"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package (``spartan_tpu``) holds field elements as 16 little-endian
16-bit limbs in uint32 ``[..., 16]``; the port as 8 little-endian 32-bit
limbs stored as int32 bit patterns ``[..., 8]``. Both use Montgomery form
with R = 2^256, so a value converts by regrouping limb pairs and nothing
else. Everything here takes and returns numpy arrays or plain Python data
and never imports the JAX package, so callers (the cross-package tests)
can hand the same generators, shapes, tables, SNARK dense representation,
commitments and proofs to both (the last two through their serialized
bytes, which are the same format in both packages).
"""

from __future__ import annotations

import numpy as np
import torch

from spartan_tpu_torch.core.commitments import MultiCommitGens
from spartan_tpu_torch.core.mle import DensePolynomial
from spartan_tpu_torch.core.r1cs import R1CSShape
from spartan_tpu_torch.ops.limbs import limbs16_to_32, limbs32_to_16


def to_port(a16, device="cpu") -> torch.Tensor:
    """JAX-layout limbs -> port tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(limbs16_to_32(a16))).to(device)


def from_port(t: torch.Tensor) -> np.ndarray:
    """Port tensor -> JAX-layout uint32 [..., 16] limbs (host)."""
    return limbs32_to_16(t.detach().to("cpu").contiguous().numpy())


def affine_to_port(x16, y16, inf, device="cpu") -> tuple:
    """JAX affine (x, y, inf) arrays -> port affine tensors."""
    return (to_port(x16, device), to_port(y16, device),
            torch.from_numpy(np.asarray(inf, dtype=bool).copy()).to(device))


def multicommit_gens(G, h, device="cpu") -> MultiCommitGens:
    """JAX ``MultiCommitGens`` tables -> the port's.

    ``G`` = (x [n, 16], y [n, 16], inf [n]) and ``h`` = (x [16], y [16],
    inf []) as numpy arrays (``np.asarray`` of the JAX gens' ``G``/``h``)."""
    g = affine_to_port(*G, device=device)
    hx, hy, hinf = affine_to_port(np.asarray(h[0])[None], np.asarray(h[1])[None],
                                  np.asarray(h[2]).reshape(1), device=device)
    return MultiCommitGens.from_points(g, (hx[0], hy[0], hinf[0]))


def r1cs_shape(num_cons: int, num_vars: int, num_inputs: int, A, B, C) -> R1CSShape:
    """Port ``R1CSShape`` from the JAX shape's entries.

    Each of A, B, C is (rows, cols, vals): index arrays and canonical
    values (the JAX ``SparseMatPolynomial``'s ``rows``, ``cols``, ``vals``)."""
    def tups(m):
        rows, cols, vals = m
        return list(zip(np.asarray(rows).tolist(), np.asarray(cols).tolist(),
                        [int(v) for v in vals]))

    return R1CSShape(num_cons, num_vars, num_inputs, tups(A), tups(B), tups(C))


def dense_poly(Z16, device="cpu") -> DensePolynomial:
    """JAX ``DensePolynomial`` table [N, 16] -> the port's."""
    return DensePolynomial(to_port(Z16, device))


def dense_rep(num_cells: int, row_addr, col_addr, vals16, device="cpu"):
    """The port's SNARK dense representation of the JAX one's data.

    ``row_addr``/``col_addr``: the per-matrix address arrays
    (``ops_addr_usize`` of the JAX ``AddrTimestamps``); ``vals16``: the
    value tables [N, 16] (``np.asarray`` of each ``val[i].Z``). The
    timestamps are derived from the addresses, as the JAX package derives
    them."""
    from spartan_tpu_torch.core import sparse_mlpoly_full as full

    num_ops = len(row_addr[0])
    return full.MultiSparseMatPolynomialAsDense(
        len(vals16),
        full.AddrTimestamps(num_cells, num_ops, list(row_addr), torch.device(device)),
        full.AddrTimestamps(num_cells, num_ops, list(col_addr), torch.device(device)),
        [dense_poly(v, device) for v in vals16])


def r1cs_commitment(raw: bytes, pcs: str = "hyrax"):
    """A serialized ``R1CSCommitment`` (either package's bytes) -> the port's."""
    from spartan_tpu_torch.core.r1cs import R1CSCommitment
    from spartan_tpu_torch.utils.serialization import deserialize

    return deserialize(R1CSCommitment, raw, pcs=pcs)


def snark_proof(raw: bytes, pcs: str = "hyrax"):
    """A serialized ``SNARK`` proof (either package's bytes, made with the
    derefs commitment ``pcs``) -> the port's."""
    from spartan_tpu_torch.snark import SNARK
    from spartan_tpu_torch.utils.serialization import deserialize

    return deserialize(SNARK, raw, pcs=pcs)


__all__ = ["limbs16_to_32", "limbs32_to_16", "to_port", "from_port", "affine_to_port",
           "multicommit_gens", "r1cs_shape", "dense_poly", "dense_rep", "r1cs_commitment",
           "snark_proof"]
