"""Build and cache directories of the port, inside the checkout.

Everything the port builds or caches at run time lands under one
directory, ``build/`` beside the package (listed in ``.gitignore``):
``build/kernels`` for the CUDA libraries, ``build/cache/native`` for the
host C library, ``build/cache/gens`` for Pedersen generator tables and
``build/cache/srs`` for the KZG SRS.
"""

from __future__ import annotations

import os


def build_path(*names: str) -> str:
    """A path under ``build/``, nothing created."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "build", *names)


def build_root() -> str:
    root = build_path()
    os.makedirs(root, exist_ok=True)
    return root


def subdir(*names: str) -> str:
    d = os.path.join(build_root(), *names)
    os.makedirs(d, exist_ok=True)
    return d
