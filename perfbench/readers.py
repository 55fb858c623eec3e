"""Shared arithmetic of the per-layer metric readers (``perfbench/metrics``).

A reader gets the traced run's bundle: ``setup`` (the set-up's timed
parts, in seconds), ``proofs`` (per proof of the window: the program's
``spans`` as (depth, label, seconds) and its ``kernels`` launch records
with ``device_ms``), ``verifies`` (the seconds of each of the window's
verifies) and ``trace`` (``tracing.read`` of the profiler). It
returns the metric's value, or None where the run has nothing to read.
"""

from __future__ import annotations


def span_per_proof(bundle: dict, label: str) -> float | None:
    """Mean over the window's proofs of the seconds in spans ``label``."""
    per = [sum(dt for _, name, dt in p["spans"] if name == label) for p in bundle["proofs"]
           if any(name == label for _, name, _ in p["spans"])]
    return sum(per) / len(per) if per else None
