"""Seconds per proof in the Montgomery encodes of witness-length vectors in
the R1CS proof (the port's ``witness_encode`` spans: the witness for its
commitment, z for the sparse products, z again for phase 2)."""

from perfbench.readers import span_per_proof

LAYER = "R1CS proof"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "witness_encode")
