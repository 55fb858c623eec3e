"""Seconds per proof in which rank 0's card runs an NCCL kernel inside the
proves: the union of the intervals of the device events whose names start
with ``nccl``, within the ``perfbench.prove`` ranges, over the proofs. An
NCCL kernel runs from the moment its rank enters the collective until every
rank has, so this counts the wait for the slowest rank with the transfer.
Nothing where the trace holds no NCCL kernel (one card, or gloo)."""

from perfbench.tracing import PROVE, overlap, union

LAYER = "collectives"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    events = bundle["trace"].get("events", [])
    nccl = union([(s, e) for n, d, s, e in events if d and n.startswith("nccl") and e > s])
    proves = union([(s, e) for n, d, s, e in events if not d and n == PROVE])
    if not nccl or not proves or not bundle["proofs"]:
        return None
    return overlap(nccl, proves) / 1e6 / len(bundle["proofs"])
