"""Seconds per verify of the port's verifier over the window's proofs (a
host clock around each verify, ending in a device synchronise): the cell's
verify time where it is too unsteady for an end-to-end bound. The warm-up's
one verify is part of the set-up."""

LAYER = "verifier"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"


def read(bundle: dict):
    v = bundle["verifies"]
    return sum(v) / len(v) if v else None
