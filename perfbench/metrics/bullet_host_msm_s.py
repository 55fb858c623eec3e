"""Seconds per proof in the host MSMs of the bullet reductions' host tails
(the port's ``bullet.host_msm`` spans: Gamma, L and R in host C)."""

from perfbench.readers import span_per_proof

LAYER = "lookup argument"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "bullet.host_msm")
