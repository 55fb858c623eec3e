"""Seconds per proof in the lookup argument's product layer (the port's
``product_layer_proof`` span: the batched product-tree sumchecks)."""

from perfbench.readers import span_per_proof

LAYER = "lookup argument"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "product_layer_proof")
