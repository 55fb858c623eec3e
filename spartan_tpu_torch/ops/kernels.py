"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source under ``spartan_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library with a plain
C interface and loaded with ``ctypes``. Libraries are built on first use
into ``build/kernels`` (see ``utils/cachedir.py``), keyed by a hash of the
source, the shared headers (``bn254.cuh``, ``transcript.cuh``) and the
flags, so an unchanged
source is never rebuilt. ``build_all`` starts one ``nvcc`` per missing
library, all at once, and waits for them together; ptxas's report of each
kernel's registers and spills is kept beside the library (``ptxas``).

Every wrapper that launches a kernel calls ``count(name)`` right there and
nowhere else, so ``counts()`` says which kernels a run went through. Each
wrapper's body runs inside ``timed`` and calls its C function through the
``launch`` that ``timed`` yields: while ``Timer.collect()`` is on, that
records the wrapper's host time and CUDA events around the launch, keyed
by kernel, entry, call site and size (``timings``). Nothing here runs
at import: every module must import on a machine without CUDA or
``nvcc``, where the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time

import torch

from spartan_tpu_torch.utils.cachedir import subdir
from spartan_tpu_torch.utils.timer import Timer

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
HEADERS = ("bn254.cuh", "transcript.cuh")
SOURCES = {
    "field_ew": "field_ew.cu",          # H1
    "curve_ew": "curve_ew.cu",          # H2
    "msm_bucket": "msm_bucket.cu",      # H3
    "msm_weighted": "msm_weighted.cu",  # H4
    "sc_fold": "sc_fold.cu",                      # S1
    "sc_round_prod": "sc_round_prod.cu",          # S2
    "sc_round_additive": "sc_round_additive.cu",  # S3
    "sc_round_quad": "sc_round_quad.cu",          # S4
    "sc_transcript": "sc_transcript.cu",          # T1
    "sc_tail": "sc_tail.cu",                      # T2
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U64P = ctypes.POINTER(ctypes.c_ulonglong)  # host array of device pointers
# exported C functions: name -> argument types (all return cudaError_t as int)
_SIGNATURES = {
    "field_ew": {"field_ew_launch": [_I, _I, _P, _L, _P, _L, _P, _L, _P]},
    "curve_ew": {"curve_padd_launch": [_P] * 9 + [_L, _P],
                 "curve_pdbl_launch": [_P] * 6 + [_L, _P],
                 "curve_horner_launch": [_P] * 3 + [_I, _I, _L] + [_P] * 4,
                 "curve_scalar_mul_launch": [_P, _I] + [_P] * 3 + [_L] + [_P] * 4},
    "msm_bucket": {"msm_bucket_launch": [_P] * 5 + [_I] * 4 + [_P] * 7 + [_L] + [_P] * 4
                   + [_L, _P, _P]},
    "msm_weighted": {"msm_weighted_launch": [_P] * 3 + [_I, _I, _I, _L] + [_P] * 3 + [_L]
                     + [_P] * 4},
    "sc_fold": {"sc_fold_launch": [_U64P, _I, _P, _L, _I, _P]},
    "sc_round_prod": {"sc_round_prod_launch": [_I, _U64P, _I, _P, _L, _I, _P, _P]},
    "sc_round_additive": {"sc_round_additive_launch": [_I, _U64P, _P, _L, _I, _P, _P]},
    "sc_round_quad": {"sc_round_quad_launch": [_I, _U64P, _P, _L, _I, _P, _P]},
    "sc_transcript": {"sc_transcript_launch": [_P, _P, _I] + [_P] * 5},
    "sc_tail": {"sc_tail_launch": [_P, _I, _L, _I, _I] + [_P] * 6 + [_I, _I, _P]},
}

_libs: dict = {}
_launches = {name: 0 for name in SOURCES}
# while Timer collects: (kernel, entry, site, n, host s, [(start, end event)])
_timed: list = []


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for fn in (SOURCES[name], *HEADERS):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def so_path(name: str) -> str:
    return os.path.join(subdir("kernels"), f"{name}_{_digest(name)}.so")


def build_all(names=None) -> dict:
    """Build every missing library, one nvcc per source, in parallel.

    Returns {name: seconds} for the libraries it built; raises with the
    compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(so_path(n))]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = so_path(n)[:-3] + f".tmp{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    took, errors = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {SOURCES[n]} failed:\n{out.decode(errors='replace')}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        with open(so_path(n)[:-3] + ".ptxas.txt", "wb") as f:
            f.write(out)
        os.replace(tmp, so_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def parse_ptxas(text: str) -> dict:
    """{function: {"registers", "spill_stores", "spill_loads", "stack"}} from
    the output of nvcc -Xptxas -v."""
    info, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)", line)
        if m:
            fn = m.group(1)
            info.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            info[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            info[fn]["registers"] = int(m.group(1))
    return info


def ptxas(name: str) -> dict:
    """ptxas's report of the library's build (``parse_ptxas``)."""
    with open(so_path(name)[:-3] + ".ptxas.txt", encoding="utf-8", errors="replace") as f:
        return parse_ptxas(f.read())


def sass(path: str) -> dict:
    """{function: {"instructions", "opcodes": {opcode: count}}} from
    ``cuobjdump -sass`` of a built library (NOPs not counted)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    info, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            info[fn] = {"instructions": 0, "opcodes": {}}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", line)
        if m and fn and m.group(1) != "NOP":
            info[fn]["instructions"] += 1
            ops = info[fn]["opcodes"]
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return info


def lib(name: str):
    """The loaded library of one kernel (built on first use)."""
    h = _libs.get(name)
    if h is None:
        build_all([name])
        h = ctypes.CDLL(so_path(name))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(h, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = h
    return h


def stream(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def count(name: str) -> None:
    _launches[name] += 1


def counts() -> dict:
    return dict(_launches)


def reset_counts() -> None:
    """Zero the launch counts and drop the timing records."""
    for k in _launches:
        _launches[k] = 0
    _timed.clear()


def _site(wrapper_file: str) -> str:
    """``module.function`` of the first frame outside this module, the
    wrapper's module and contextlib: where the kernel was asked for."""
    skip = {os.path.abspath(__file__), wrapper_file, os.path.abspath(contextlib.__file__)}
    f = sys._getframe(1)
    while f is not None and os.path.abspath(f.f_code.co_filename) in skip:
        f = f.f_back
    if f is None:
        return "?"
    mod = os.path.splitext(os.path.basename(f.f_code.co_filename))[0]
    return f"{mod}.{f.f_code.co_name}"


def _direct(fn, *args):
    return fn(*args)


class _Launches:
    """Calls C launch functions with CUDA events on the current stream
    right before and after each (the kernel's device time)."""

    def __init__(self):
        self.events = []

    def __call__(self, fn, *args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        rc = fn(*args)
        e.record()
        self.events.append((s, e))
        return rc


@contextlib.contextmanager
def timed(name: str, entry: str, n: int, device):
    """Around a wrapper's body (checks, allocation, launch); yields the
    function the body calls its C launch function through,
    ``launch(lib.fn, *args)``. While ``Timer.collect()`` is on and
    ``device`` is a card, it records the body's host time and CUDA events
    around the launch (read in ``timings``, so nothing synchronises here);
    otherwise ``launch`` just calls."""
    if not Timer.collecting() or device.type != "cuda":
        yield _direct
        return
    site = _site(os.path.abspath(sys._getframe(2).f_code.co_filename))
    launches = _Launches()
    t = time.perf_counter()
    yield launches
    if launches.events:
        _timed.append((name, entry, site, n, time.perf_counter() - t, launches.events))


def timings() -> list:
    """The launches recorded by ``timed`` since ``reset_counts``, summed by
    (kernel, entry, call site, size): [{"kernel", "entry", "site", "n",
    "launches", "device_ms", "host_ms"}], largest device time first.
    device_ms sums the kernels' event times, host_ms the wrapper calls'."""
    agg: dict = {}
    for name, entry, site, n, host, events in _timed:
        r = agg.setdefault((name, entry, site, n), [0, 0.0, 0.0])
        for s, e in events:
            e.synchronize()
            r[0] += 1
            r[1] += s.elapsed_time(e)
        r[2] += host * 1e3
    rows = [{"kernel": k[0], "entry": k[1], "site": k[2], "n": k[3], "launches": v[0],
             "device_ms": v[1], "host_ms": v[2]} for k, v in agg.items()]
    return sorted(rows, key=lambda r: -r["device_ms"])
