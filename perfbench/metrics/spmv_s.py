"""Seconds per proof in the phase-1 sparse products Az, Bz, Cz (the port's
``sc1_spmv_AzBzCz`` span)."""

from perfbench.readers import span_per_proof

LAYER = "R1CS proof"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "sc1_spmv_AzBzCz")
