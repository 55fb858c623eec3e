"""Seconds of ``SNARK.encode`` in set-up, ending in a device synchronise."""

LAYER = "entry"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"


def read(bundle: dict):
    return bundle["setup"].get("encode_s")
