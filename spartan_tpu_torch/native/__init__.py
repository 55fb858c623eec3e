"""Native host kernels: build-on-first-import C library with ctypes bindings.

Provides ``keccak_f1600(state: bytearray)`` and the host G1/Fr backend of
``g1_host.c`` (the MSM oracle and the verifier's MSMs). The .r1cs parser
in ``spartan_native.c`` is built but not bound until ingestion is ported. Falls back to pure Python automatically if no
compiler is present (``available`` is False then); callers never need to
branch — they import the dispatching wrappers from the usual modules.

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
