"""Seconds per proof in the R1CS satisfiability proof (the port's
``R1CSProof::prove`` span: both sumcheck phases, the witness commitment and
its opening)."""

from perfbench.readers import span_per_proof

LAYER = "R1CS proof"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "R1CSProof::prove")
