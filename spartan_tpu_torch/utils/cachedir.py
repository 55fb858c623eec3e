"""Build and cache directories of the port, inside the checkout.

Everything the port builds or caches at run time lands under one
directory, ``build/`` beside the package (listed in ``.gitignore``):
``build/kernels`` for the CUDA libraries, ``build/cache/native`` for the
host C library and ``build/cache/gens`` for Pedersen generator tables.
"""

from __future__ import annotations

import os


def build_root() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.join(os.path.dirname(pkg), "build")
    os.makedirs(root, exist_ok=True)
    return root


def subdir(*names: str) -> str:
    d = os.path.join(build_root(), *names)
    os.makedirs(d, exist_ok=True)
    return d
