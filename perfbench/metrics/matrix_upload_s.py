"""Seconds per proof in getting the R1CS matrices onto the device (the
port's ``matrix_device_copy`` span, around ``SparseMatPolynomial``'s device
copies and row/column boundaries, cache hits included): the values'
Montgomery encode, the index uploads and the ``searchsorted`` a SNARK
redoes in every prove, since it frees the copies before the lookup argument."""

from perfbench.readers import span_per_proof

LAYER = "R1CS proof"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "matrix_device_copy")
