"""Seconds per proof in the bullet reductions' provers (the port's
``bullet.reduce`` spans: every round of every log-size dot-product
opening, on the card or on the host)."""

from perfbench.readers import span_per_proof

LAYER = "lookup argument"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "bullet.reduce")
