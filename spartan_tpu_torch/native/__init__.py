"""Native host kernels: build-on-first-import C library with ctypes bindings.

Provides ``keccak_f1600(state: bytearray)``, STROBE's absorb of a whole
message (``strobe_absorb_native``), the circom ``.r1cs``
constraints parser of ``spartan_native.c`` (``r1cs_parse_native``) and the
host G1/Fr backend of ``g1_host.c`` (the MSM oracle and the verifier's
MSMs). Falls back to pure Python automatically if no compiler is present
(``available`` is False then); callers never need to branch — they import
the dispatching wrappers from the usual modules.

The library is built with ``-march=native``, so the cached ``.so`` is keyed
on the CPU that built it as well as on the sources and flags: a checkout
shared between machines never loads a library built for another CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "spartan_native.c"),
         os.path.join(_HERE, "g1_host.c")]

available = False
g1_available = False
_lib = None


def _cpu_identity() -> bytes:
    """Machine type plus the CPU feature flags this host reports."""
    ident = platform.machine().encode()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    ident += b"|" + line.strip()
                    break
    except OSError:
        ident += b"|" + platform.processor().encode()
    return ident


def _build() -> str | None:
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(b"flags:O3-native-v1")  # flag changes must miss the .so cache
    h.update(_cpu_identity())
    digest = h.hexdigest()[:16]
    try:
        from spartan_tpu_torch.utils.cachedir import subdir

        cache_dir = subdir("cache", "native")
    except OSError:
        cache_dir = tempfile.gettempdir()
    so_path = os.path.join(cache_dir, f"spartan_native_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    try:
        # -O3 halves fq_mul latency vs -O2; -march=native is safe because
        # the cache key above carries the CPU identity. Retries drop the
        # flags a local compiler may reject.
        for extra in (["-O3", "-march=native", "-funroll-loops"], ["-O3"],
                      ["-O2"]):
            cmd = ["cc", *extra, "-fPIC", "-shared", "-o", tmp] + _SRCS
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(tmp, so_path)
                return so_path
            except (subprocess.SubprocessError, OSError):
                continue
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, available
    so = _build()
    if so is None:
        return
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return
    lib.keccak_f1600.argtypes = [ctypes.c_char_p]
    lib.keccak_f1600.restype = None
    lib.strobe_absorb.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
                                  ctypes.c_char_p, ctypes.c_uint64]
    lib.strobe_absorb.restype = ctypes.c_uint32
    lib.r1cs_count.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int64)]
    lib.r1cs_count.restype = ctypes.c_int64
    lib.r1cs_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_uint32] + [ctypes.c_void_p] * 9
    lib.r1cs_parse.restype = ctypes.c_int64
    _lib = lib
    available = True

    global g1_available
    try:
        lib.g1_msm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_uint64,
                               ctypes.c_char_p, ctypes.c_char_p]
        lib.g1_msm.restype = None
        lib.g1_dual_mul_many.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p]
        lib.g1_dual_mul_many.restype = None
        lib.g1_scalar_mul.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint8,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.g1_scalar_mul.restype = None
        lib.fr_batch_mont.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p]
        lib.fr_batch_mont.restype = None
        g1_available = True
    except AttributeError:
        pass


def fr_batch_mont(data: bytes, n: int, to_mont: bool) -> bytes:
    """n 32-byte LE Fr values: canonical<->Montgomery batch conversion."""
    out = ctypes.create_string_buffer(32 * n)
    _lib.fr_batch_mont(data, n, 1 if to_mont else 0, out)
    return out.raw


_load()


def keccak_f1600_bytes_native(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (C fast path)."""
    buf = (ctypes.c_char * 200).from_buffer(state)
    _lib.keccak_f1600(buf)


def strobe_absorb_native(state: bytearray, pos: int, pos_begin: int,
                         data: bytes) -> tuple[int, int]:
    """STROBE-128's absorb of ``data`` into the 200-byte ``state`` at
    ``pos`` (C fast path of ``Strobe128._absorb``, a permutation at every
    rate boundary); returns the new ``(pos, pos_begin)``."""
    buf = (ctypes.c_char * 200).from_buffer(state)
    out = _lib.strobe_absorb(buf, pos, pos_begin, bytes(data), len(data))
    return out & 0xFF, out >> 8


def r1cs_parse_native(data: bytes, off: int, num_constraints: int, field_size: int):
    """The .r1cs constraints section -> 3 x (rows, cols, vals_raw) numpy
    arrays (int64, int64, uint8 of field_size bytes per entry).

    Returns None if the native library is unavailable or the buffer is
    malformed (callers fall back to the Python parser).
    """
    import numpy as np

    if not available:
        return None
    counts = (ctypes.c_int64 * 3)()
    total = _lib.r1cs_count(data, len(data), off, num_constraints, field_size, counts)
    if total < 0:
        return None
    out = []
    ptrs = []
    for m in range(3):
        n = counts[m]
        rows = np.empty(n, dtype=np.int64)
        cols = np.empty(n, dtype=np.int64)
        vals = np.empty(n * field_size, dtype=np.uint8)
        out.append((rows, cols, vals))
        ptrs += [rows.ctypes.data_as(ctypes.c_void_p),
                 cols.ctypes.data_as(ctypes.c_void_p),
                 vals.ctypes.data_as(ctypes.c_void_p)]
    got = _lib.r1cs_parse(data, len(data), off, num_constraints, field_size, *ptrs)
    if got != total:
        return None
    return out
