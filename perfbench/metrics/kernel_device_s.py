"""Device seconds per proof of the port's hand-written CUDA kernels: the sum
of ``ops/kernels.timings()`` ``device_ms``, CUDA events around each launch."""

LAYER = "kernels"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"


def read(bundle: dict):
    per = [sum(k["device_ms"] for k in p["kernels"]) / 1e3 for p in bundle["proofs"]]
    if not per or not any(per):
        return None
    return sum(per) / len(per)
