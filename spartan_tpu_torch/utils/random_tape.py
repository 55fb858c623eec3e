"""Prover randomness tape.

A private merlin transcript seeded from OS randomness; all ZK blinds come
from here, never from the public proof transcript
(reference src/random.rs:10-32). A fixed seed may be injected for
reproducible tests / bit-reproducible multi-host proving (every host must
hold the same tape).
"""

from __future__ import annotations

import os

from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.transcript import Transcript


class RandomTape:
    def __init__(self, name: bytes, seed: bytes | None = None):
        tape = Transcript(name)
        init = seed if seed is not None else os.urandom(32)
        # Reference appends a random scalar under label "init_randomness"
        # (random.rs:15-23); any 32-byte canonical value works here.
        tape.append_scalar(b"init_randomness", int.from_bytes(init, "little") % FR_MOD)
        self.tape = tape

    def random_scalar(self, label: bytes) -> int:
        return self.tape.challenge_scalar(label)

    def random_vector(self, label: bytes, n: int) -> list[int]:
        return self.tape.challenge_vector(label, n)
