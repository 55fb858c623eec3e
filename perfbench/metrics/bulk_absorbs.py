"""Messages per proof that the transcript absorbed in one native call (the
port's ``strobe.bulk_absorb`` spans): 1 in a NIZK prove, whose shape digest
is tens of MB, 0 where every append is shorter than a STROBE block."""

LAYER = "entry"
UNIT = "absorbs"
BETTER = "higher"
MOVES = "prove_s"


def read(bundle: dict):
    per = [sum(name == "strobe.bulk_absorb" for _, name, _ in p["spans"])
           for p in bundle["proofs"]]
    return sum(per) / len(per) if per else None
