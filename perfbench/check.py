"""Deciding ``correct``: the plain verifier of ``perfbench/reference`` judges
what the window produced, from the benchmark's own inputs.

It works out the instance again from the generator's matrices (for the
SNARK its whole commitment, compared row by row with the one the port's
encode made; for the NIZK the instance's digest) and verifies a sample of
the window's proofs, drawn from the seed, each against the public inputs
of the witness its iteration proved. Every proof has a random tape of its
own, so no two proofs of the window may be the same bytes. Every number it
compares is returned with its limit: ``value <= limit`` holds for a
correct run.
"""

from __future__ import annotations

import hashlib
import random
import sys

from perfbench.reference import proof as P
from perfbench.reference import spartan as V
from perfbench.reference.r1cs import Commitment, Matrices

LABEL = b"perfbench"


class Reference:
    """The reference's view of one instance; its commitment (SNARK) or
    digest (NIZK) is worked out on first use and kept."""

    def __init__(self, inputs: dict, traffic: dict):
        self.m = Matrices(inputs["num_cons"], inputs["num_vars"], inputs["num_inputs"],
                          *inputs["matrices"])
        self.traffic = traffic
        self.r1cs_gens = V.R1CSGens(self.m.num_vars)
        self._prefix = self._comm = None

    def verify(self, raw: bytes, public: list[int]) -> None:
        """Raises if the proof's bytes fail against the public inputs."""
        if self.traffic["proof"] == "nizk":
            if self._prefix is None:
                self._prefix = V.nizk_prefix(LABEL, self.m.digest())
            V.verify_nizk(P.nizk(raw), self._prefix, self.m, public, self.r1cs_gens)
        else:
            V.verify_snark(P.snark(raw, self.traffic["pcs"]), LABEL, self.commitment(), public,
                           self.r1cs_gens, self.gens)

    def commitment(self) -> Commitment:
        if self._comm is None:
            nnz = max(len(v) for _, _, v in self.m.mats)
            self.gens = V.EvalGens(self.m.num_cons, self.m.num_vars, nnz, self.traffic["pcs"],
                                   self.traffic.get("srs_seed"))
            self._comm = Commitment(self.m, self.gens)
        return self._comm

    def judge(self, publics: list[list[int]], proofs: list[bytes], commitment: bytes | None,
              seed: int, failed: int) -> dict:
        """{name: {"value", "limit"}} of every number compared; ``publics[i]``
        are the public inputs ``proofs[i]`` was proved for."""
        out = {"failed_iterations": {"value": failed, "limit": 0},
               "duplicate_proofs": {"value": len(proofs) - len(
                   {hashlib.sha256(raw).digest() for raw in proofs}), "limit": 0}}
        if self.traffic["proof"] != "nizk":
            comm = self.commitment()
            try:
                off = comm.differing_rows(P.commitment(commitment))
            except ValueError:
                off = len(comm.ops_points) + len(comm.mem_points)
            out["commitment_rows_off"] = {"value": off, "limit": 0}
        pick = random.Random(seed).sample(range(len(proofs)),
                                          min(self.traffic["reference_sample"], len(proofs)))
        rejected = 0
        for i in pick:
            try:
                self.verify(proofs[i], publics[i])
            except (V.Reject, ValueError) as e:
                rejected += 1
                print(f"reference rejects proof {i}: {e}", file=sys.stderr, flush=True)
        out["rejected_proofs"] = {"value": rejected, "limit": 0}
        out["proofs_unchecked"] = {"value": int(not pick), "limit": 0}
        return out
