"""Limb-decomposed big-integer representation of the port.

Device layout: a 254-bit BN254 field element is 8 little-endian limbs of
32 bits, stored as ``int32`` bit patterns on the last axis, shape
``[..., 8]``. The host side works in ``uint32`` numpy arrays of the same
layout; ``np.ndarray.view`` moves between the two without copying.

The JAX package keeps 16 limbs of 16 bits (``spartan_tpu/ops/limbs.py``);
with the same Montgomery factor R = 2^256 both hold the same integer, so
a value converts by regrouping limb pairs (``limbs16_to_32`` and
``limbs32_to_16``: the KZG SRS file and ``spartan_tpu_torch.interop``).
"""

from __future__ import annotations

import numpy as np
import torch

NUM_LIMBS = 8


def ints_to_limbs(xs, num_limbs: int = NUM_LIMBS) -> np.ndarray:
    """List of ints -> [N, num_limbs] uint32 array (one bytes join)."""
    xs = list(xs)
    if not xs:
        return np.zeros((0, num_limbs), dtype=np.uint32)
    nb = 4 * num_limbs
    buf = b"".join(x.to_bytes(nb, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u4").reshape(len(xs), num_limbs).copy()


def limbs_to_ints(arr) -> list[int]:
    """[N, L] uint32/int32 array -> list of Python ints (via packed bytes)."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype == np.int32:
        a = a.view(np.uint32)
    a = a.astype("<u4", copy=False)
    if a.ndim == 1:
        a = a[None]
    n, nl = a.shape
    raw = a.tobytes()
    nb = 4 * nl
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little") for i in range(n)]


def to_tensor(limbs_u32: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy limbs -> int32 torch tensor (bit pattern) on ``device``."""
    a = np.ascontiguousarray(limbs_u32, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 torch limbs -> uint32 numpy array (host copy)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


def limbs16_to_32(a16) -> np.ndarray:
    """uint32 [..., 16] of 16-bit limbs -> int32 [..., 8] (32-bit limbs)."""
    a = np.asarray(a16).astype(np.uint32, copy=False)
    w = (a[..., 0::2] & np.uint32(0xFFFF)) | (a[..., 1::2] << np.uint32(16))
    return w.view(np.int32)


def limbs32_to_16(a32) -> np.ndarray:
    """int32/uint32 [..., 8] of 32-bit limbs -> uint32 [..., 16]."""
    w = np.asarray(a32)
    w = w.view(np.uint32) if w.dtype == np.int32 else w.astype(np.uint32)
    out = np.stack((w & np.uint32(0xFFFF), w >> np.uint32(16)), axis=-1)
    return out.reshape(*w.shape[:-1], 2 * w.shape[-1])
