"""Bullet rounds per proof that ran on the card (the port's
``bullet.device_round`` spans): 0 for a proof whose reductions ran all
on the host, nothing for a program without ``bullet.reduce`` spans."""

LAYER = "lookup argument"
UNIT = "rounds"
BETTER = "higher"
MOVES = "prove_s"


def read(bundle: dict):
    per = [sum(name == "bullet.device_round" for _, name, _ in p["spans"])
           for p in bundle["proofs"]
           if any(name == "bullet.reduce" for _, name, _ in p["spans"])]
    return sum(per) / len(per) if per else None
