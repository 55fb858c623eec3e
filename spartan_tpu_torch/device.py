"""Which torch device the prover's tensors live on.

The entry points (``NIZKGens``, ``NIZK.prove``/``verify``) run on the CUDA
card unless the caller asks for the CPU. They resolve the device once and
hold it for the duration of the call with ``use``; everything below them
that creates a tensor from host data asks ``current()``. Field and curve
ops themselves follow the device of the tensors they are given: on a CPU
tensor every kernel wrapper runs its plain PyTorch version, on a CUDA
tensor it launches the kernel.
"""

from __future__ import annotations

import contextlib

import torch

_stack: list[torch.device] = []


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card; raises if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    return dev


@contextlib.contextmanager
def use(device):
    """Make ``device`` the current device inside the block."""
    _stack.append(resolve(device))
    try:
        yield _stack[-1]
    finally:
        _stack.pop()


def current() -> torch.device:
    """The innermost ``use`` device, else the CUDA card (raises if none)."""
    if _stack:
        return _stack[-1]
    return resolve(None)
