"""Run-time configuration of the port: the reference's Cargo features as data.

Counterpart of ``spartan_tpu/config.py``, reading the same environment
variables when a ``SpartanConfig`` is made: the polynomial commitment of
the derefs (``SPARTAN_TPU_PCS``), where the KZG SRS is kept
(``SPARTAN_TPU_SRS``, by default under the port's ``build/cache/srs``) and
the seed it is generated from when it is missing (``SPARTAN_TPU_SRS_SEED``),
a fixed MSM window for every MSM (``msm_window``, read from ``DEFAULT`` by
``ops/msm.py``; None picks it by size) and whether ``keyless_bench.run``
prints its phases (``SPARTAN_TPU_PROFILE=1``). The JAX config's
``mesh_devices`` has no counterpart: a sharded prove is given its mesh
(``parallel.make_mesh``) as ``mesh=``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _default_srs_path() -> str:
    from spartan_tpu_torch.utils.cachedir import build_path

    return build_path("cache", "srs", "spartan_tpu_srs.npz")


@dataclass
class SpartanConfig:
    # polynomial commitment scheme of the derefs: 'hyrax' | 'kzg'
    pcs: str = field(default_factory=lambda: os.environ.get("SPARTAN_TPU_PCS", "hyrax"))
    # KZG SRS file and the seed of the deterministic test SRS (kzg.rs:58-63)
    srs_path: str = field(default_factory=lambda: os.environ.get("SPARTAN_TPU_SRS")
                          or _default_srs_path())
    srs_seed: int = field(default_factory=lambda: int(
        os.environ.get("SPARTAN_TPU_SRS_SEED", str(0xDEADBEEF))))
    # MSM window override (None = by size, ops/msm.py choose_window)
    msm_window: int | None = None
    # print the phases' times (utils/timer.py Timer.enable)
    profile: bool = field(default_factory=lambda: os.environ.get("SPARTAN_TPU_PROFILE") == "1")

    def __post_init__(self):
        if self.pcs not in ("hyrax", "kzg"):
            raise ValueError(f"unknown PCS mode: {self.pcs}")


DEFAULT = SpartanConfig()
