"""The system under test: the calls the benchmark makes into
``spartan_tpu_torch``. Nothing else in the benchmark imports the port.

``Prover`` is built in set-up from the generator's inputs (the instance,
the generators, the SRS and, for a SNARK, the encode) and then proves and
verifies one witness per call, each in assignments of its own. Given the
port's ``mesh`` (``join_mesh``), it encodes and proves sharded over the
mesh's ranks, each rank calling it alike.
"""

from __future__ import annotations

import time

import torch

from spartan_tpu_torch.core.r1cs import R1CSShape
from spartan_tpu_torch.io.r1cs_reader import R1CSFile
from spartan_tpu_torch.ops import kernels
from spartan_tpu_torch.snark import NIZK, SNARK, Assignment, Instance, NIZKGens, SNARKGens
from spartan_tpu_torch.utils.math import log_2, next_power_of_two, pow2
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.serialization import serialize
from spartan_tpu_torch.utils.timer import Timer
from spartan_tpu_torch.utils.transcript import Transcript

LABEL = b"perfbench"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    t = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t


def build_kernels(device: torch.device) -> None:
    """Build the port's CUDA libraries that the checkout lacks."""
    if device.type == "cuda":
        kernels.build_all()


def join_mesh(init_method: str, rank: int, world_size: int, device: torch.device,
              backend: str):
    """Join the port's process group as ``rank`` of ``world_size`` on
    ``device`` over ``backend``; the port's mesh of that world."""
    from spartan_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(init_method=init_method, rank=rank, world_size=world_size,
                     backend=backend, device=device)
    return make_mesh(world_size, device=device)


class Prover:
    """Set-up of one cell's prover; ``setup_spans`` holds the set-up's
    timed parts (``encode_s``, ``srs_s``) in seconds."""

    def __init__(self, inputs: dict, traffic: dict, device: torch.device, mesh=None):
        self.kind = traffic["proof"]
        self.pcs = traffic.get("pcs")
        self.mesh = mesh
        self.setup_spans: dict = {}
        build_kernels(device)
        if "r1cs_path" in inputs:
            self._load_circom(inputs)
        else:
            self._load_spartan(inputs)
        n_cons, n_vars = self.inst.inst.num_cons, self.inst.inst.num_vars
        n_in = self.inst.inst.num_inputs
        if self.kind == "nizk":
            self.gens = NIZKGens(n_cons, n_vars, n_in, device=device)
            return
        srs = None
        if self.pcs == "kzg":
            from spartan_tpu_torch.pcs.kzg import KZGSrs

            # the derefs (3 matrices x row and column) of 2^k entries each
            # are committed as one vector of 8 * 2^k coefficients
            size = pow2(log_2(max(2, next_power_of_two(self.max_nnz))) + 3) + 1
            srs, self.setup_spans["srs_s"] = _timed(
                lambda: KZGSrs.setup_from_seed(size, traffic["srs_seed"], device=device),
                device)
        self.gens = SNARKGens(n_cons, n_vars, n_in, self.max_nnz, pcs=self.pcs,
                              kzg_srs=srs, device=device)
        (self.comm, self.decomm), self.setup_spans["encode_s"] = _timed(
            lambda: SNARK.encode(self.inst, self.gens, mesh=mesh), device)

    def _load_circom(self, inputs: dict) -> None:
        r = R1CSFile.from_file(inputs["r1cs_path"])
        n_vars = next_power_of_two(max(r.num_private_vars(), r.num_pub_inputs + 1))
        n_cons = next_power_of_two(max(r.num_constraints, 2))
        A, B, C = r.to_sparse_matrices_padded(n_vars)
        shape = R1CSShape(n_cons, n_vars, r.num_pub_inputs, A, B, C)
        self.inst = Instance.from_shape(shape)
        self.num_vars = n_vars
        self.max_nnz = max(len(shape.A.vals), len(shape.B.vals), len(shape.C.vals))

    def _load_spartan(self, inputs: dict) -> None:
        tuples = [list(zip(r.tolist(), c.tolist(), v)) for r, c, v in inputs["matrices"]]
        shape = R1CSShape(inputs["num_cons"], inputs["num_vars"], inputs["num_inputs"], *tuples)
        self.inst = Instance.from_shape(shape)
        self.num_vars = inputs["num_vars"]
        self.max_nnz = max(len(v) for _, _, v in inputs["matrices"])

    def assign(self, witness) -> tuple[Assignment, Assignment]:
        """New assignment objects (private values zero-padded, public inputs)
        of one witness (inputs, vars)."""
        inputs, vars_ = witness
        return (Assignment(list(vars_) + [0] * (self.num_vars - len(vars_))),
                Assignment(list(inputs)))

    def prove(self, tape_seed: bytes, vars_: Assignment, inputs: Assignment):
        if self.kind == "nizk":
            return NIZK.prove(self.inst, vars_, inputs, self.gens, Transcript(LABEL),
                              RandomTape(b"proof", seed=tape_seed), mesh=self.mesh)
        return SNARK.prove(self.inst, self.comm, self.decomm, vars_, inputs, self.gens,
                           Transcript(LABEL), RandomTape(b"snark_proof", seed=tape_seed),
                           mesh=self.mesh)

    def verify(self, proof, inputs: Assignment) -> None:
        """The port's own verifier; raises if it rejects the proof."""
        if self.kind == "nizk":
            proof.verify(self.inst, inputs, Transcript(LABEL), self.gens)
        else:
            proof.verify(self.comm, inputs, Transcript(LABEL), self.gens)

    def commitment_bytes(self) -> bytes | None:
        return None if self.kind == "nizk" else serialize(self.comm)

    @staticmethod
    def proof_bytes(proof) -> bytes:
        return serialize(proof)


# -- what a traced run reads from the program ---------------------------------------

def collect(on: bool) -> None:
    """Turn the program's span and kernel-event recording on or off."""
    Timer.collect(on)
    kernels.reset_counts()


def spans() -> list:
    """(depth, label, seconds) of every program span since ``collect``."""
    return Timer.records()


def kernel_timings() -> list:
    """The port's kernel launches since ``collect``, with device ms."""
    return kernels.timings()
