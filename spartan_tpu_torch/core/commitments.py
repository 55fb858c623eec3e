"""Pedersen vector commitments over the device MSM.

Counterpart of ``spartan_tpu/core/commitments.py`` (itself the reference's
commitments.rs):
- ``MultiCommitGens``: generators derived deterministically by a Shake256
  XOF over a label (commitments.rs:31-62), each 64-byte read mapped to a
  point exactly like the reference's simplified hash-to-group
  (group.rs:110-132, fallback quirks included) or, with ``secure=True``,
  by x-coordinate rejection sampling (no discrete log known), kept as
  affine tensors on the prover's device, with the tables cached on disk
  under ``build/cache/gens``;
- ``commit`` / ``commit_rows``: (n+1)-point MSMs; the row-batched form is
  the Hyrax matrix commit (hyrax.rs:253-267) as one batched MSM.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import curve_host as CH
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import msm as MSM
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.ops.limbs import to_numpy, to_tensor
from spartan_tpu_torch.utils.timer import Timer


def _gen_scalars_from_label(label: bytes, count: int) -> list[int]:
    """Shake256(label || compressed_G) -> `count` generator dlog scalars.

    Reproduces MultiCommitGens::new + GroupElement::from_uniform_bytes,
    including the reference's non-canonical-bytes fallback chain.
    """
    shake = hashlib.shake_256()
    shake.update(label)
    shake.update(CH.compress(CH.GEN))
    stream = shake.digest(64 * count)
    out = []
    for i in range(count):
        uniform = stream[64 * i: 64 * i + 64]
        h = hashlib.sha3_256(uniform).digest()
        v = int.from_bytes(h, "little")
        if v < FR_MOD:
            out.append(v)
            continue
        h2 = hashlib.sha3_256(b"fallback" + uniform).digest()
        v2 = int.from_bytes(h2, "little")
        out.append(v2 if v2 < FR_MOD else 1)
    return out


# element budget per commit_rows MSM call (rows x R); module-level so tests
# can shrink it to exercise the row-chunk boundaries
ROWS_BUDGET = 1 << 23

_FIXED_BASE_C = 8
_fixed_base_tables: dict = {}  # device -> affine table [32 * 256]
# up to this many scalars, generators are derived on the host C backend
HOST_FIXED_BASE_N = 4096


def _fixed_base_windows(device):
    """Precomputed k * 2^(8w) * G for w in 0..31, k in 0..255 (host-built)."""
    key = str(device)
    if key not in _fixed_base_tables:
        pts = []
        base = CH.GEN
        for _w in range(32):
            acc = None
            for _k in range(256):
                pts.append(acc)
                acc = CH.add(acc, base)
            base = CH.scalar_mul(1 << _FIXED_BASE_C, base)
        _fixed_base_tables[key] = CU.encode_points_affine(pts, device)
    return _fixed_base_tables[key]


# scalars per fixed-base gather pass: bounds the digit, index and gathered
# point transients (~3.5 KB a scalar, ~1 GB a pass); module-level so tests
# can shrink it
FIXED_BASE_CHUNK = 1 << 18


def points_from_scalars(scalars, device=None):
    """s_i * G for each scalar, as affine (x, y, inf) tensors.

    ``scalars``: Python ints, or canonical limbs [n, 8] already on the
    device. Small batches of ints run on the host C backend; large ones
    gather from the fixed-base window table (32 windows of 8 bits over
    256-bit scalars) and add the 32 gathered points with H2, one chunk of
    scalars at a time.
    """
    dev = DEV.current() if device is None else torch.device(device)
    if isinstance(scalars, torch.Tensor):
        sc = scalars.to(dev)
    elif len(scalars) <= HOST_FIXED_BASE_N:
        pts = [CH.scalar_mul(s % FR_MOD, CH.GEN) for s in scalars]
        return CU.encode_points_affine(pts, dev)
    else:
        sc = F.encode_canonical([s % FR_MOD for s in scalars], dev)
    tx, ty, tinf = _fixed_base_windows(dev)
    offsets = torch.arange(32, device=dev) << _FIXED_BASE_C
    parts = []
    for start in range(0, sc.shape[0], FIXED_BASE_CHUNK):
        digits = MSM.window_digits(sc[start:start + FIXED_BASE_CHUNK], _FIXED_BASE_C,
                                   num_bits=256)                       # [chunk, 32]
        ix = digits.long() + offsets
        del digits
        proj = CU.from_affine(tx[ix], ty[ix], tinf[ix])
        parts.append(MSM.reduce_points(proj, axis=1))
    proj = tuple(torch.cat([p[i] for p in parts], dim=0) for i in range(3))
    del parts
    return CU.batch_normalize(proj)


def _gens_cache_dir() -> str:
    from spartan_tpu_torch.utils.cachedir import subdir

    return subdir("cache", "gens")


class MultiCommitGens:
    """n Pedersen generators + blinding generator h, on the prover's device.

    ``G`` is an affine (x, y, inf) tuple of [n] tensors and ``h`` one
    affine point (x, y, inf) of [8]/[] tensors."""

    def __init__(self, n: int, label: bytes | None = None, _from=None,
                 secure: bool = False, device=None):
        """By default the generators reproduce the reference's simplified
        scalar*G hash-to-group byte-for-byte (group.rs:110-132), which
        transcript parity with the reference requires (their dlogs are
        public, as in the reference, so the commitments do not bind).
        ``secure=True`` derives them by x-coordinate rejection sampling
        (``curve_host.from_uniform_bytes_secure``): no dlog is known and
        the commitments bind. That derivation is host Python (about two
        square roots in Fq a point), cached on disk like the default one."""
        self.n = n
        if _from is not None:
            self.G, self.h = _from
            self.device = self.G[0].device
            return
        assert label is not None
        self.device = DEV.current() if device is None else torch.device(device)
        pts = self._derive_cached(label, n, self.device, secure)
        self.G = tuple(a[:n] for a in pts)
        self.h = tuple(a[n] for a in pts)

    @staticmethod
    def _derive_secure(label: bytes, count: int) -> list:
        """``count`` host points of unknown dlog from Shake256(label ||
        compressed_G), 64 bytes a point."""
        shake = hashlib.shake_256()
        shake.update(label)
        shake.update(CH.compress(CH.GEN))
        stream = shake.digest(64 * count)
        return [CH.from_uniform_bytes_secure(stream[64 * i: 64 * i + 64])
                for i in range(count)]

    @staticmethod
    def _derive_cached(label: bytes, n: int, device, secure: bool):
        """The n + 1 points, from the on-disk cache when present."""
        mode = b"u32x8|secure|" if secure else b"u32x8|"
        key = hashlib.sha256(mode + label + b"|" + str(n).encode()).hexdigest()[:24]
        path = os.path.join(_gens_cache_dir(), f"gens_{key}.npz")
        try:
            d = np.load(path)
            return (to_tensor(d["x"], device), to_tensor(d["y"], device),
                    torch.from_numpy(d["inf"]).to(device))
        except (OSError, KeyError, ValueError):
            pass
        if secure:
            pts = CU.encode_points_affine(MultiCommitGens._derive_secure(label, n + 1), device)
        else:
            pts = points_from_scalars(_gen_scalars_from_label(label, n + 1), device)
        try:
            tmp = f"{path}.{os.getpid()}.npz"
            with open(tmp, "wb") as fh:
                np.savez(fh, x=to_numpy(pts[0]), y=to_numpy(pts[1]),
                         inf=pts[2].to("cpu").numpy())
            os.replace(tmp, path)
        except OSError:
            pass
        return pts

    # -- structural ops (commitments.rs:64-114) --------------------------------

    def split_at(self, mid: int):
        left = MultiCommitGens(mid, _from=(tuple(a[:mid] for a in self.G), self.h))
        right = MultiCommitGens(self.n - mid, _from=(tuple(a[mid:] for a in self.G), self.h))
        return left, right

    def scale(self, s: int) -> "MultiCommitGens":
        from spartan_tpu_torch.core import hostpath as HP

        if self.n <= HP.HOST_MSM_N:
            Gs, _h = self.host_points()
            scaled = [CH.scalar_mul(s, p) for p in Gs]
            pts = CU.encode_points_affine(scaled, self.device)
            out = MultiCommitGens(self.n, _from=(pts, self.h))
            out._host_pts = (scaled, _h)
            return out
        sc = F.encode_canonical([s % FR_MOD] * self.n, self.device)
        proj = CU.scalar_mul(sc, CU.from_affine(*self.G))
        return MultiCommitGens(self.n, _from=(CU.batch_normalize(proj), self.h))

    @staticmethod
    def from_points(G_affine, h_affine) -> "MultiCommitGens":
        return MultiCommitGens(G_affine[0].shape[0], _from=(G_affine, h_affine))

    def extended_points(self):
        """(G_0..G_{n-1}, h) as one affine tuple for (n+1)-MSMs."""
        return tuple(torch.cat((g, h.unsqueeze(0)), dim=0) for g, h in zip(self.G, self.h))

    def host_points(self) -> tuple[list, CH.Point]:
        cached = getattr(self, "_host_pts", None)
        if cached is None:
            cached = (_decode_affine(self.G), _decode_affine(
                tuple(a.unsqueeze(0) for a in self.h))[0])
            self._host_pts = cached
        return cached


def _decode_affine(pts) -> list:
    """Affine (x, y, inf) tensors -> host points (None for infinity)."""
    x, y, inf = pts
    xs = F.decode_fq(x)
    ys = F.decode_fq(y)
    return [None if i else (a, b) for a, b, i in zip(xs, ys, inf.reshape(-1).tolist())]


def commit(values: list[int], blind: int, gens: MultiCommitGens) -> GroupElem:
    """<values, G> + blind*h as a host GroupElem (commitments.rs:118-154)."""
    assert len(values) == gens.n
    from spartan_tpu_torch.core import hostpath as HP

    if gens.n <= HP.HOST_MSM_N:
        Gs, h = gens.host_points()
        return GroupElem(CH.msm([v % FR_MOD for v in values] + [blind % FR_MOD],
                                Gs + [h]))
    sc = F.encode_canonical([v % FR_MOD for v in values] + [blind % FR_MOD], gens.device)
    pt = MSM.msm(gens.extended_points(), sc)
    return GroupElem(CU.decode_points(tuple(a.unsqueeze(0) for a in pt))[0])


def commit_scalar(value: int, blind: int, gens: MultiCommitGens) -> GroupElem:
    assert gens.n == 1
    return commit([value], blind, gens)


def commit_device(values_mont, blind_mont, gens: MultiCommitGens):
    """Device-side commit: values [n, 8] Montgomery; returns projective point."""
    vals = F.fr.from_mont(torch.cat((values_mont, blind_mont.unsqueeze(0)), dim=0))
    return MSM.msm(gens.extended_points(), vals)


def commit_rows(Z_mont, blinds_mont, gens: MultiCommitGens, mesh=None):
    """Hyrax row commits: Z [L, R] x shared gens (+ per-row blind*h).

    Z_mont: [L, R, 8] Montgomery; blinds_mont: [L, 8] Montgomery. Returns
    projective points batched [L]: one batched MSM, chunked over rows so
    the canonical-scalar and digit transients stay bounded. With ``mesh``
    the rows are sharded over the ranks (the same affine points).
    """
    L, R = Z_mont.shape[0], Z_mont.shape[1]
    assert R == gens.n
    if mesh is not None and mesh.size > 1 and L >= mesh.size:
        from spartan_tpu_torch.parallel.msm_sharded import commit_rows_sharded

        return commit_rows_sharded(mesh, Z_mont, blinds_mont, gens)
    rows_max = max(1, min(L, ROWS_BUDGET // (R + 1)))
    n_chunks = -(-L // rows_max)
    rows_per = -(-L // n_chunks)
    pts = gens.extended_points()
    parts = []
    for start in range(0, L, rows_per):
        stop = min(start + rows_per, L)
        with Timer.stage("msm.from_mont", Z_mont.device):
            sc = F.fr.from_mont(torch.cat((Z_mont[start:stop],
                                           blinds_mont[start:stop].unsqueeze(1)), dim=1))
        parts.append(MSM.msm(pts, sc))
    return tuple(torch.cat([p[i] for p in parts], dim=0) for i in range(3))

