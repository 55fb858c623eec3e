"""spartan_tpu_torch: the Spartan zkSNARK (BN254, Hyrax or KZG) on PyTorch + CUDA.

The port of ``spartan_tpu`` to an NVIDIA H100. It mirrors the JAX
package's module layout and produces byte-identical proofs; its field,
curve, MSM and sumcheck-round kernels are hand-written CUDA (``csrc/``),
built with ``nvcc`` for ``sm_90a`` on first use. Entry points run on the CUDA card
unless given ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version; with ``mesh=`` (``parallel/``) a prove is sharded over
the ranks of a ``torch.distributed`` group. Nothing here imports JAX or
``spartan_tpu``.

Public API (lazy, so importing the package stays cheap and loads no CUDA):
the 30 names ``spartan_tpu`` exports, so a user switches packages by the
import line —

- the snark surface: Assignment, VarsAssignment, InputsAssignment,
  Instance, NIZK, NIZKGens, SNARK, SNARKGens;
- the protocol objects: R1CSShape, R1CSGens, R1CSProof, DensePolynomial,
  EqPolynomial, MultiCommitGens, GroupElem, SumcheckInstanceProof,
  ZKSumcheckInstanceProof, UniPoly, CompressedUniPoly, PolyCommitmentGens,
  PolyEvalProof, KZGSrs;
- the utilities: Transcript, RandomTape, ProofVerifyError, R1CSError,
  Timer, SpartanConfig;
- the circom readers: R1CSFile, parse_wtns;

and besides them the sparse matrices (SparseMatPolynomial,
SparseMatEntry) and the KZG classes of ``pcs/kzg.py``.
"""

from __future__ import annotations

_EXPORTS = {
    # snark surface
    **{name: ("spartan_tpu_torch.snark", name) for name in (
        "Assignment", "VarsAssignment", "InputsAssignment", "Instance", "NIZK", "NIZKGens",
        "SNARK", "SNARKGens")},
    # core protocol objects
    "R1CSShape": ("spartan_tpu_torch.core.r1cs", "R1CSShape"),
    "R1CSGens": ("spartan_tpu_torch.core.r1csproof", "R1CSGens"),
    "R1CSProof": ("spartan_tpu_torch.core.r1csproof", "R1CSProof"),
    "DensePolynomial": ("spartan_tpu_torch.core.mle", "DensePolynomial"),
    "EqPolynomial": ("spartan_tpu_torch.core.mle", "EqPolynomial"),
    "MultiCommitGens": ("spartan_tpu_torch.core.commitments", "MultiCommitGens"),
    "GroupElem": ("spartan_tpu_torch.core.group", "GroupElem"),
    "SumcheckInstanceProof": ("spartan_tpu_torch.core.sumcheck", "SumcheckInstanceProof"),
    "ZKSumcheckInstanceProof": ("spartan_tpu_torch.core.sumcheck", "ZKSumcheckInstanceProof"),
    "UniPoly": ("spartan_tpu_torch.core.unipoly", "UniPoly"),
    "CompressedUniPoly": ("spartan_tpu_torch.core.unipoly", "CompressedUniPoly"),
    "PolyCommitmentGens": ("spartan_tpu_torch.pcs.hyrax", "PolyCommitmentGens"),
    "PolyEvalProof": ("spartan_tpu_torch.pcs.hyrax", "PolyEvalProof"),
    "SparseMatPolynomial": ("spartan_tpu_torch.core.sparse_mlpoly", "SparseMatPolynomial"),
    "SparseMatEntry": ("spartan_tpu_torch.core.sparse_mlpoly", "SparseMatEntry"),
    # utilities
    "Transcript": ("spartan_tpu_torch.utils.transcript", "Transcript"),
    "RandomTape": ("spartan_tpu_torch.utils.random_tape", "RandomTape"),
    "ProofVerifyError": ("spartan_tpu_torch.utils.errors", "ProofVerifyError"),
    "R1CSError": ("spartan_tpu_torch.utils.errors", "R1CSError"),
    "Timer": ("spartan_tpu_torch.utils.timer", "Timer"),
    "SpartanConfig": ("spartan_tpu_torch.config", "SpartanConfig"),
    # ingestion
    "R1CSFile": ("spartan_tpu_torch.io.r1cs_reader", "R1CSFile"),
    "parse_wtns": ("spartan_tpu_torch.io.r1cs_reader", "parse_wtns"),
    # KZG
    **{name: ("spartan_tpu_torch.pcs.kzg", name) for name in (
        "KZGSrs", "KZGCommitment", "KZGProof", "KZGBatchProof", "KZGPolyCommitmentGens",
        "KZGPolyCommitment", "KZGPolyEvalProof", "KZGBatchedCommitment",
        "KZGBatchedEvalProof")},
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod, attr = _EXPORTS[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'spartan_tpu_torch' has no attribute {name!r}")
