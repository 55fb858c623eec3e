"""Seconds per proof that no span below the prove explains: the root span
(``SNARK::prove`` or ``NIZK::prove``) less the spans one level below it."""

LAYER = "entry"
UNIT = "s"
BETTER = "lower"
MOVES = "prove_s"

ROOTS = ("SNARK::prove", "NIZK::prove")


def read(bundle: dict):
    per = []
    for p in bundle["proofs"]:
        roots = [dt for depth, name, dt in p["spans"] if depth == 0 and name in ROOTS]
        if roots:
            per.append(sum(roots) - sum(dt for depth, _, dt in p["spans"] if depth == 1))
    return sum(per) / len(per) if per else None
