"""Seconds of ``KZGSrs.setup_from_seed`` in set-up (the SRS of a KZG cell,
made on the device and never written to disk), ending in a synchronise."""

LAYER = "commitments"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"


def read(bundle: dict):
    return bundle["setup"].get("srs_s")
