"""The shared kernel header ``csrc/bn254.cuh`` built as plain C++ against the
plain PyTorch versions, bit for bit.

The host build runs the header's carry-chain field arithmetic with each
PTX carry instruction emulated (one thread-local carry flag), so it checks
the word-by-word algorithm every kernel runs: the Montgomery product, adds
and subtracts, the complete formulas and H2's two ladders. The transcript
header ``csrc/transcript.cuh`` (T1 and T2's sponge and round step) is built
with it and held to ``utils/strobe.py``, ``ops/keccak.py`` and the plain
versions of ``ops/transcript_device.py``. The PTX itself is checked only on
the card (``chip_smoke.py``, the ``gpu`` tests). The harness below is
compiled with ``g++`` into a temporary library.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import curve_host as CH
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import fields_host as fh
from spartan_tpu_torch.ops import transcript_device as TD
from spartan_tpu_torch.ops.keccak import keccak_f1600
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "spartan_tpu_torch", "csrc")

HARNESS = r"""
#include <stdint.h>
struct uint4 { uint32_t x, y, z, w; };
#include "bn254.cuh"
using namespace bn254;

extern "C" void field_op(int op, int fq, const uint32_t* a, const uint32_t* b,
                         uint32_t* r, long n) {
  for (long i = 0; i < n; i++) {
    const uint32_t *x = a + 8 * i, *y = b + 8 * i;
    uint32_t* o = r + 8 * i;
    if (op == 0) { if (fq) fe_mul<Fq>(o, x, y); else fe_mul<Fr>(o, x, y); }
    if (op == 1) { if (fq) fe_add<Fq>(o, x, y); else fe_add<Fr>(o, x, y); }
    if (op == 2) { if (fq) fe_sub<Fq>(o, x, y); else fe_sub<Fr>(o, x, y); }
  }
}

extern "C" void point_op(int op, const uint4* x1, const uint4* y1, const uint4* z1,
                         const uint4* x2, const uint4* y2, const uint4* z2,
                         uint4* ox, uint4* oy, uint4* oz, long n) {
  for (long i = 0; i < n; i++) {
    const Point P = load_point(x1, y1, z1, i);
    store_point(ox, oy, oz, i, op == 0 ? padd(P, load_point(x2, y2, z2, i)) : pdbl(P));
  }
}

extern "C" void horner(const uint4* x, const uint4* y, const uint4* z, int W, int c,
                       long B, uint4* ox, uint4* oy, uint4* oz) {
  for (long i = 0; i < B; i++) store_point(ox, oy, oz, i, horner_ladder(x, y, z, i, B, W, c));
}

extern "C" void scalar_mul(const uint32_t* k, int nbits, const uint4* x, const uint4* y,
                           const uint4* z, long n, uint4* ox, uint4* oy, uint4* oz) {
  for (long i = 0; i < n; i++)
    store_point(ox, oy, oz, i, scalar_mul_ladder(load_point(x, y, z, i), k + 8 * i, nbits));
}

#include "transcript.cuh"

// Keccak-f[1600] across the emulated warp's lanes
extern "C" void tr_keccak(uint64_t* lanes) {
  sctr::run_warp([&](sctr::Warp w) {
    uint64_t a = w.lane() < 25 ? lanes[w.lane()] : 0;
    sctr::keccak_lanes(w, a);
    w.sync();
    if (w.lane() < 25) lanes[w.lane()] = a;
  });
}

// one STROBE operation on a packed sponge, on the warp: 0 meta_ad, 1 ad
// (framing and data absorbed as one string), 2 prf (framing with the C
// flag, then the squeeze)
extern "C" void tr_op(int32_t* sponge, int op, const uint8_t* data, int n, uint8_t* out) {
  sctr::Sponge sp;
  memcpy(&sp, sponge, sizeof(sp));
  static uint8_t buf[2 + 256];
  memcpy(buf + 2, data, op == 2 ? 0 : n);
  const int off[1] = {0};
  const uint8_t flags[1] = {(uint8_t)(op == 2 ? sctr::FLAG_I | sctr::FLAG_A | sctr::FLAG_C
                                      : op == 0 ? sctr::FLAG_M | sctr::FLAG_A : sctr::FLAG_A)};
  sctr::run_warp([&](sctr::Warp w) {
    sctr::WSponge s = sctr::ws_load(w, &sp);
    sctr::warp_absorb(w, s, buf, op == 2 ? 2 : 2 + n, off, flags, 1);
    if (op == 2) sctr::warp_squeeze(w, s, out, n);
    w.sync();
    sctr::ws_store(w, s, &sp);
  });
  memcpy(sponge, &sp, sizeof(sp));
}

extern "C" void tr_bytes64(const uint8_t* b, uint32_t* out) {
  sctr::run_warp([&](sctr::Warp w) {
    const sctr::Fe r = sctr::challenge_to_fr(w, b);
    if (w.lane() == 0) sctr::st(out, 0, r);
  });
}

// T1's whole body (t1_round, what the kernel runs) on the emulated warp
extern "C" void tr_round(const uint32_t* evals, const uint32_t* coeffs, int ninst,
                         uint32_t* claim, int32_t* sponge, uint32_t* poly, uint32_t* r) {
  sctr::Sponge sp;
  alignas(16) uint8_t buf[sctr::ROUND_BUF];
  sctr::Fe out[6];
  sctr::run_warp([&](sctr::Warp w) {
    sctr::t1_round(w, evals, coeffs, ninst, claim, sponge, poly, r, &sp, buf, out);
  });
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the header's host build")
    d = tmp_path_factory.mktemp("bn254_host")
    src, so = d / "harness.cpp", d / "harness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(so), str(src)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(so))
    for fn in (h.field_op, h.point_op, h.horner, h.scalar_mul, h.tr_keccak, h.tr_op,
               h.tr_bytes64, h.tr_round):
        fn.restype = None
    return h


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _out_like(coords):
    return tuple(torch.empty_like(c) for c in coords)


def rand_field(spec, n, seed):
    """n canonical elements, 0, 1 and p - 1 first."""
    rng = np.random.default_rng(seed)
    xs = [0, 1, spec.modulus - 1] + [int.from_bytes(rng.bytes(32), "little") % spec.modulus
                                      for _ in range(n - 3)]
    return F.encode_canonical(xs, "cpu") if spec is F.FR else F.encode_fq(xs, "cpu")


@pytest.mark.parametrize("spec", [F.FR, F.FQ], ids=["Fr", "Fq"])
def test_field_ops_match_plain(lib, spec):
    a, b = rand_field(spec, 64, 1), rand_field(spec, 64, 2).flip(0).contiguous()
    for code, op in enumerate(("mul", "add", "sub")):
        out = torch.empty_like(a)
        lib.field_op(code, int(spec is F.FQ), _p(a), _p(b), _p(out), ctypes.c_long(64))
        assert torch.equal(out, F.field_ew_plain(op, spec, a, b)), op


def proj(pts, seed):
    with DEV.use("cpu"):
        p = CU.encode_points(pts)
        rng = np.random.default_rng(seed)
        z = F.encode_fq([int(v) % (fh.FQ_MOD - 1) + 1
                         for v in rng.integers(1, 1 << 62, size=len(pts))])
    return tuple(F.fq.mul(c, z) for c in p)


PTS = [CH.scalar_mul(k, CH.GEN) for k in (3, 5, 7, 11, 13, 17)]


def test_point_ops_match_plain(lib):
    A = [None, PTS[0], PTS[1], PTS[2], PTS[3], None]
    B = [PTS[4], None, PTS[1], CH.neg(PTS[2]), PTS[5], None]
    P, Q = proj(A, 1), proj(B, 2)
    for code, want in ((0, CU.padd_plain(P, Q)), (1, CU.pdbl_plain(P))):
        out = _out_like(P)
        lib.point_op(code, *map(_p, P + Q + out), ctypes.c_long(len(A)))
        assert all(torch.equal(o, w) for o, w in zip(out, want))


@pytest.mark.parametrize("c,W", [(3, 4), (7, 3)])
def test_horner_ladder_matches_plain(lib, c, W):
    cols = [proj([PTS[(w + i) % 6] if (w + i) % 5 else None for i in range(4)], w)
            for w in range(W)]
    win = tuple(torch.stack([col[k] for col in cols]).contiguous() for k in range(3))
    out = _out_like(tuple(a[0] for a in win))
    lib.horner(*map(_p, win), W, c, ctypes.c_long(4), *map(_p, out))
    assert all(torch.equal(o, w) for o, w in zip(out, CU.horner_plain(win, c)))


def test_scalar_mul_ladder_matches_plain(lib):
    ks = [0, 1, fh.FR_MOD - 1, 12345678901234567]
    sc = F.encode_canonical(ks, "cpu")
    P = proj([PTS[0], None, PTS[1], PTS[1]], 3)
    out = _out_like(P)
    lib.scalar_mul(_p(sc), 254, *map(_p, P), ctypes.c_long(4), *map(_p, out))
    assert all(torch.equal(o, w) for o, w in zip(out, CU.scalar_mul_plain(sc, P, 254)))


def test_transcript_header_matches_strobe(lib):
    """Keccak-f[1600] and the STROBE operations of transcript.cuh against
    ops/keccak.py and utils/strobe.py, on a packed sponge."""
    rng = np.random.default_rng(13)
    lanes = [int(v) for v in rng.integers(0, 1 << 63, size=25, dtype=np.uint64) * 2 + 1]
    arr = np.asarray(lanes, dtype=np.uint64)
    lib.tr_keccak(arr.ctypes.data_as(ctypes.c_void_p))
    assert [int(v) for v in arr] == keccak_f1600(lanes)

    t = Transcript(b"header")
    h = t.strobe
    sponge = TD.pack_sponge(t, "cpu")
    out = np.zeros(200, dtype=np.uint8)
    for _ in range(60):
        op = int(rng.integers(0, 3))
        n = int(rng.integers(1, 180))
        data = np.frombuffer(rng.bytes(n), dtype=np.uint8).copy()
        lib.tr_op(_p(sponge), op, data.ctypes.data_as(ctypes.c_void_p), n,
                  out.ctypes.data_as(ctypes.c_void_p))
        if op == 0:
            h.meta_ad(data.tobytes(), False)
        elif op == 1:
            h.ad(data.tobytes(), False)
        else:
            assert out[:n].tobytes() == h.prf(n, False)
    assert TD.unpack_sponge(sponge) == (bytes(h.state), h.pos, h.pos_begin)


def test_transcript_header_round_matches_plain(lib):
    """transcript.cuh's 64-byte challenge reduction and T1's round step
    (the function the kernel runs) against the plain versions, over a
    chain of rounds on one sponge."""
    rng = np.random.default_rng(14)
    for raw in [b"\xff" * 64, bytes(64)] + [rng.bytes(64) for _ in range(6)]:
        b = np.frombuffer(raw, dtype=np.uint8).copy()
        got = torch.zeros(8, dtype=torch.int32)
        lib.tr_bytes64(b.ctypes.data_as(ctypes.c_void_p), _p(got))
        assert torch.equal(got, TD.bytes64_to_fr_mont(torch.from_numpy(b)))

    I = 18
    t = Transcript(b"round chain")
    sponges = [TD.pack_sponge(t, "cpu") for _ in range(2)]
    claims = [F.encode_fr([99], device="cpu")[0].clone() for _ in range(2)]
    coeffs = rand_field(F.FR, I, 15)
    for j in range(12):
        evals = rand_field(F.FR, 3 * I, 16 + j)
        outs = [(torch.zeros((4, 8), dtype=torch.int32), torch.zeros(8, dtype=torch.int32))
                for _ in range(2)]
        lib.tr_round(_p(evals), _p(coeffs), I, _p(claims[0]), _p(sponges[0]),
                     _p(outs[0][0]), _p(outs[0][1]))
        TD.round_transcript_plain(evals, coeffs, claims[1], sponges[1], *outs[1])
        assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert torch.equal(claims[0], claims[1]) and torch.equal(sponges[0], sponges[1])


def test_transcript_header_round_every_position(lib):
    """T1's body on the emulated warp from every position of the sponge
    modulo the rate (0 .. 165), so F falls at every byte of the round's
    string, against the host transcript (utils/strobe.py) doing the same
    round; 1, 18 and 40 instances (lanes with none, one and two)."""
    from spartan_tpu_torch.core.unipoly import UniPoly

    P = fh.FR_MOD
    rng = np.random.default_rng(17)
    for pos in range(166):
        I = (1, 18, 40)[pos % 3]
        state = rng.bytes(200)
        pos_begin = int(rng.integers(0, pos + 1))
        ev = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(3 * I)]
        co = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(I)]
        e = int.from_bytes(rng.bytes(32), "little") % P
        sponge = torch.from_numpy(np.concatenate((np.frombuffer(state, dtype="<i4"),
                                                  np.asarray([pos, pos_begin], "<i4"))).copy())
        claim = F.encode_fr([e], device="cpu")[0].clone()
        evals, coeffs = F.encode_fr(ev, device="cpu"), F.encode_fr(co, device="cpu")
        poly, r = torch.zeros((4, 8), dtype=torch.int32), torch.zeros(8, dtype=torch.int32)
        lib.tr_round(_p(evals), _p(coeffs), I, _p(claim), _p(sponge), _p(poly), _p(r))

        t = Transcript(b"unused")
        t.strobe.state, t.strobe.pos, t.strobe.pos_begin = bytearray(state), pos, pos_begin
        c = [sum(ev[3 * i + k] * co[i] for i in range(I)) % P for k in range(3)]
        up = UniPoly.from_evals([c[0], (e - c[0]) % P, c[1], c[2]])
        up.append_to_transcript(b"poly", t)
        r_host = t.challenge_scalar(b"challenge_nextround")
        assert F.decode_fr(poly) == up.coeffs, pos
        assert F.decode_fr(r[None])[0] == r_host, pos
        assert F.decode_fr(claim[None])[0] == up.evaluate(r_host), pos
        assert TD.unpack_sponge(sponge) == (bytes(t.strobe.state), t.strobe.pos,
                                            t.strobe.pos_begin), pos
