"""spartan_tpu_torch: the Spartan zkSNARK (BN254, Hyrax or KZG) on PyTorch + CUDA.

The port of ``spartan_tpu`` to an NVIDIA H100. It mirrors the JAX
package's module layout and produces byte-identical proofs; its field,
curve, MSM and sumcheck-round kernels are hand-written CUDA (``csrc/``),
built with ``nvcc`` for ``sm_90a`` on first use. Entry points run on the CUDA card
unless given ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version; with ``mesh=`` (``parallel/``) a prove is sharded over
the ranks of a ``torch.distributed`` group. Nothing here imports JAX or
``spartan_tpu``.

Public API (lazy, so importing the package stays cheap): Assignment,
Instance, NIZKGens, NIZK, SNARKGens, SNARK, Transcript, RandomTape,
SpartanConfig, the KZG classes of ``pcs/kzg.py`` and the circom readers
(R1CSFile, parse_wtns).
"""

from __future__ import annotations

_EXPORTS = {
    "Assignment": ("spartan_tpu_torch.snark", "Assignment"),
    "Instance": ("spartan_tpu_torch.snark", "Instance"),
    "NIZKGens": ("spartan_tpu_torch.snark", "NIZKGens"),
    "NIZK": ("spartan_tpu_torch.snark", "NIZK"),
    "SNARKGens": ("spartan_tpu_torch.snark", "SNARKGens"),
    "SNARK": ("spartan_tpu_torch.snark", "SNARK"),
    "Transcript": ("spartan_tpu_torch.utils.transcript", "Transcript"),
    "RandomTape": ("spartan_tpu_torch.utils.random_tape", "RandomTape"),
    "SpartanConfig": ("spartan_tpu_torch.config", "SpartanConfig"),
    "R1CSFile": ("spartan_tpu_torch.io.r1cs_reader", "R1CSFile"),
    "parse_wtns": ("spartan_tpu_torch.io.r1cs_reader", "parse_wtns"),
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
