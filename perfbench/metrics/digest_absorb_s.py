"""Seconds per proof in absorbing the R1CS shape's digest into the
transcript (the port's ``shape_digest_absorb`` span in ``NIZK.prove``)."""

from perfbench.readers import span_per_proof

LAYER = "entry"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "shape_digest_absorb")
