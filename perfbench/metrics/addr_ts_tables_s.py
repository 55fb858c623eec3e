"""Seconds per proof in building the lookup argument's address and
timestamp tables on the device (the port's ``addr_ts_tables`` spans,
around each ``AddrTimestamps.ops_addr``, ``read_ts`` and ``audit_ts``)."""

from perfbench.readers import span_per_proof

LAYER = "lookup argument"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    return span_per_proof(bundle, "addr_ts_tables")
