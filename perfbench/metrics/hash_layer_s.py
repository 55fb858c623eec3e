"""Seconds per proof in the lookup argument's hash layer (the port's
``hash_layer_proof`` span: the derefs and the comb_ops/comb_mem openings)."""

from perfbench.readers import span_per_proof

LAYER = "lookup argument"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "hash_layer_proof")
