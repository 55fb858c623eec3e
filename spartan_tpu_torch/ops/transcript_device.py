"""Device-resident merlin transcript: Keccak-f[1600] + STROBE-128 in PyTorch.

Counterpart of ``spartan_tpu/ops/transcript_device.py``. The host
transcript (``utils/transcript.py``) needs every sumcheck round's
evaluations on the host before it can squeeze the next challenge, so a
driver on it (the ZK sumchecks, a mesh's rounds) pays one device-to-host
read a round. With the sponge on
the device the fused sumcheck (``core/sumcheck_fused.py``) keeps the
challenge -> fold -> evaluations recurrence on the card; the host replays
the round polynomials through its own transcript afterwards and asserts
the challenges agree.

Everything here works on tensors and is exact: the sponge is a uint8 [200]
state, Keccak-f[1600] runs on 64-bit lanes held as int64 with masked
shifts (CPU torch has no uint64 shift), and field elements are the
port's [8] int32 Montgomery limbs, computed with the plain field functions
of ``ops/field.py`` (independent of every kernel). This module is the
plain version of kernel T1 (``csrc/sc_transcript.cu``, the Fiat-Shamir
step of one sumcheck round, ``round_transcript``), whose device code is
``csrc/transcript.cuh``; on the CPU it is what the fused path runs.

``DynStrobe`` keeps the sponge positions as tensors, as the JAX package's
traced positions, so a round's step reads and writes one packed sponge
tensor (``pack_sponge``: int32 [52], the 200 state bytes then pos and
pos_begin, the layout the kernels take). Where the kernel branches on the
position (run F at the rate boundary), this plain version reads the
position tensor on the host. The JAX package's static-position
``DeviceStrobe``/``DeviceTranscript`` have no counterpart: no path of the
port runs them.

Bit-compatibility is that of ``utils/strobe.py``: STROBE v1.0.2, 128-bit
level, rate 166, merlin framing.
"""

from __future__ import annotations

import numpy as np
import torch

from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops.field import fr_add_plain as _add
from spartan_tpu_torch.ops.field import fr_mul_plain as _mul
from spartan_tpu_torch.ops.field import fr_sub_plain as _sub
from spartan_tpu_torch.ops.keccak import _ROT, _ROUND_CONSTANTS
from spartan_tpu_torch.ops.limbs import NUM_LIMBS, ints_to_limbs, to_tensor

_STROBE_R = 166
SPONGE_WORDS = 52   # int32 words of a packed sponge: 200 state bytes, pos, pos_begin

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_M = 1 << 4


def _i64(v: int) -> int:
    """A 64-bit pattern as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


# rho + pi wiring: lane b[i] = rol(a[_PI_SRC[i]], _PI_SROT[i])
_PI_SRC = [0] * 25
_PI_SROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _PI_SROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROT[_x][_y]


class _KeccakConsts:
    def __init__(self, device):
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
        self.src = t(_PI_SRC)
        self.shl = t(_PI_SROT)
        self.shr = t([64 - s for s in _PI_SROT])
        self.mask = t([_i64((1 << s) - 1) for s in _PI_SROT])
        self.rc = t([_i64(rc) for rc in _ROUND_CONSTANTS])


_KC: dict = {}


def _kc(device) -> _KeccakConsts:
    key = str(device)
    if key not in _KC:
        _KC[key] = _KeccakConsts(device)
    return _KC[key]


def keccak_f1600_lanes(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on int64 lanes [..., 25] (lane x + 5y; batched).

    A right shift of int64 copies the sign bit, so each rotation masks the
    bits that come in from the top."""
    C = _kc(a.device)
    for i in range(24):
        g = a.unflatten(-1, (5, 5))                       # g[..., y, x]
        c = g[..., 0, :] ^ g[..., 1, :] ^ g[..., 2, :] ^ g[..., 3, :] ^ g[..., 4, :]
        c1 = torch.roll(c, -1, -1)
        d = torch.roll(c, 1, -1) ^ ((c1 << 1) | ((c1 >> 63) & 1))
        a = (g ^ d.unsqueeze(-2)).flatten(-2)
        b = a[..., C.src]
        b = (b << C.shl) | ((b >> C.shr) & C.mask)
        g = b.unflatten(-1, (5, 5))
        a = (g ^ (~torch.roll(g, -1, -1) & torch.roll(g, -2, -1))).flatten(-2)
        a[..., 0] ^= C.rc[i]
    return a


def keccak_f1600_state(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on a uint8 [200] state (little-endian lanes)."""
    lanes = state.contiguous().view(torch.int64)
    return keccak_f1600_lanes(lanes).contiguous().view(torch.uint8)


def _u8(data, device) -> torch.Tensor:
    if isinstance(data, (bytes, bytearray)):
        return torch.tensor(list(data), dtype=torch.uint8, device=device)
    return data


# ---------------------------------------------------------------------------
# STROBE-128 with the positions as tensors (the fused rounds' sponge)
# ---------------------------------------------------------------------------

class DynStrobe:
    """STROBE-128 whose state and byte positions are tensors: ``pos`` and
    ``pos_begin`` are int64 0-dim tensors, each XOR and squeeze is an
    index computation from them. Each operation crosses the rate boundary
    at most once (callers keep chunks <= 166 bytes)."""

    __slots__ = ("state", "pos", "pos_begin")

    def __init__(self, state, pos, pos_begin):
        dev = state.device
        self.state = state.clone()
        self.pos = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(())
        self.pos_begin = torch.as_tensor(pos_begin, device=dev).to(torch.int64).reshape(())

    def _pad_and_f(self, st, at) -> torch.Tensor:
        """F with the STROBE padding XORed at position ``at`` (a tensor)."""
        st = st.clone()
        idx = torch.stack((at, at + 1))
        pad = torch.stack((self.pos_begin, torch.full_like(self.pos_begin, 0x04)))
        st.index_put_((idx,), st[idx] ^ pad.to(torch.uint8))
        st[_STROBE_R + 1] ^= 0x80
        return keccak_f1600_state(st)

    def _absorb(self, data) -> None:
        """XOR k <= 166 bytes in at the position, running F at the rate
        boundary; leftover bytes land at the start of the next block."""
        data = _u8(data, self.state.device)
        k = int(data.shape[0])
        assert k <= _STROBE_R
        dev = self.state.device
        upd = torch.zeros(_STROBE_R + k, dtype=torch.uint8, device=dev)
        upd[self.pos + torch.arange(k, device=dev)] = data
        st = self.state.clone()
        st[:_STROBE_R] ^= upd[:_STROBE_R]
        new_pos = self.pos + k
        if bool(new_pos >= _STROBE_R):
            # the rate block is full, so the pad lands at index 166
            st = self._pad_and_f(st, torch.full_like(self.pos, _STROBE_R))
            st[:k] ^= upd[_STROBE_R:]
            new_pos = new_pos - _STROBE_R
            self.pos_begin = torch.zeros_like(self.pos_begin)
        self.state = st
        self.pos = new_pos

    def _run_f_if_data(self) -> None:
        """F at the position, if the block holds data (a C operation)."""
        if bool(self.pos != 0):
            self.state = self._pad_and_f(self.state, self.pos)
            self.pos = torch.zeros_like(self.pos)
            self.pos_begin = torch.zeros_like(self.pos_begin)

    def _squeeze(self, n: int) -> torch.Tensor:
        assert n <= _STROBE_R
        dev = self.state.device
        i = self.pos + torch.arange(n, device=dev)
        first = i < _STROBE_R
        out = self.state[torch.where(first, i, 0)].clone()
        st = self.state.clone()
        st[i[first]] = 0
        if bool(self.pos + n >= _STROBE_R):
            # the squeeze reaches the boundary: F, then the rest of the
            # output comes from (and is zeroed in) the new block
            st = self._pad_and_f(st, torch.full_like(self.pos, _STROBE_R))
            j = i - _STROBE_R
            out = torch.where(first, out, st[torch.where(first, 0, j)])
            st[j[~first]] = 0
            self.pos = self.pos + n - _STROBE_R
            self.pos_begin = torch.zeros_like(self.pos_begin)
        else:
            self.pos = self.pos + n
        self.state = st
        return out

    def _framing(self, flags: int) -> torch.Tensor:
        """The framing bytes [old pos_begin, flags]; moves pos_begin."""
        old = self.pos_begin
        self.pos_begin = self.pos + 1
        return torch.stack((old, torch.full_like(old, flags))).to(torch.uint8)

    def _absorb_op(self, flags: int, parts) -> None:
        """begin_op + one absorb of the framing and the parts (non-C ops)."""
        dev = self.state.device
        self._absorb(torch.cat([self._framing(flags)] + [_u8(p, dev) for p in parts]))

    def meta_ad_op(self, *parts) -> None:
        self._absorb_op(FLAG_M | FLAG_A, parts)

    def ad_op(self, *parts) -> None:
        self._absorb_op(FLAG_A, parts)

    def prf(self, n: int) -> torch.Tensor:
        self._absorb(self._framing(FLAG_I | FLAG_A | FLAG_C))
        self._run_f_if_data()
        return self._squeeze(n)


class DynTranscript:
    """merlin transcript over DynStrobe (positions as tensors)."""

    __slots__ = ("strobe",)

    def __init__(self, state, pos, pos_begin):
        self.strobe = DynStrobe(state, pos, pos_begin)

    @staticmethod
    def from_sponge(sponge) -> "DynTranscript":
        """The transcript of a packed sponge (``pack_sponge``)."""
        return DynTranscript(sponge[:50].contiguous().view(torch.uint8), sponge[50], sponge[51])

    def carry(self):
        s = self.strobe
        return s.state, s.pos, s.pos_begin

    def append_message(self, label: bytes, message) -> None:
        nbytes = len(message) if isinstance(message, (bytes, bytearray)) \
            else int(message.shape[0])
        self.strobe.meta_ad_op(label, nbytes.to_bytes(4, "little"))
        self.strobe.ad_op(message)

    def challenge_bytes(self, label: bytes, n: int) -> torch.Tensor:
        self.strobe.meta_ad_op(label, n.to_bytes(4, "little"))
        return self.strobe.prf(n)

    def challenge_scalar(self, label: bytes) -> torch.Tensor:
        return bytes64_to_fr_mont(self.challenge_bytes(label, 64))


# ---------------------------------------------------------------------------
# field-element byte codecs ([8] int32 Montgomery limbs)
# ---------------------------------------------------------------------------

_P = F.FR.modulus


def mont_const(v: int, device=None) -> torch.Tensor:
    """v as Montgomery-form [8] limbs."""
    return to_tensor(ints_to_limbs([v * F.FR.r1 % _P])[0], device)


def raw_const(v: int, device=None) -> torch.Tensor:
    return to_tensor(ints_to_limbs([v])[0], device)


_R2 = F.FR.r2                      # R^2 mod p
_R3 = F.FR.r2 * F.FR.r1 % _P       # R^3 mod p
_TWO_INV = pow(2, -1, _P)
_SIX_INV = pow(6, -1, _P)


def frs_to_bytes_dev(xs_mont) -> torch.Tensor:
    """[..., 8] Montgomery elements -> [..., 32] canonical LE bytes."""
    canon = _mul(xs_mont, raw_const(1, xs_mont.device))
    return canon.contiguous().view(torch.uint8)


def bytes64_to_fr_mont(b64) -> torch.Tensor:
    """64 LE bytes -> the element they encode mod p, Montgomery form
    (merlin challenge_scalar: from_le_bytes_mod_order). With x = lo +
    hi 2^256, x R = mont(lo, R^2) + mont(hi, R^3)."""
    w = b64.contiguous().view(torch.int32).reshape(2, NUM_LIMBS)
    k = torch.stack((raw_const(_R2, w.device), raw_const(_R3, w.device)))
    t = _mul(w, k)
    return _add(t[0], t[1])


# ---------------------------------------------------------------------------
# the packed sponge the kernels take
# ---------------------------------------------------------------------------

def pack_sponge(transcript, device) -> torch.Tensor:
    """A host Transcript's sponge as int32 [52]: 200 state bytes, pos,
    pos_begin (the layout of ``Sponge`` in ``csrc/transcript.cuh``)."""
    s = transcript.strobe
    words = np.concatenate((np.frombuffer(bytes(s.state), dtype="<i4"),
                            np.asarray([s.pos, s.pos_begin], dtype="<i4")))
    return torch.from_numpy(words.astype(np.int32)).to(device)


def unpack_sponge(sponge) -> tuple[bytes, int, int]:
    """(state bytes, pos, pos_begin) of a packed sponge (a host read)."""
    w = sponge.detach().to("cpu")
    return bytes(w[:50].contiguous().view(torch.uint8).tolist()), int(w[50]), int(w[51])


# ---------------------------------------------------------------------------
# T1: one batched product-sumcheck round's Fiat-Shamir step
# ---------------------------------------------------------------------------

def _cubic_from_evals(e0, e1, e2, e3):
    """UniPoly.from_evals of degree 3 in Montgomery form, coefficients low
    to high [4, 8] (unipoly.rs:34-38)."""
    e1x3 = _add(_add(e1, e1), e1)
    e2x3 = _add(_add(e2, e2), e2)
    ta = _sub(_add(e3, e1x3), _add(e2x3, e0))
    e0x2 = _add(e0, e0)
    e2x4 = _add(_add(e2, e2), _add(e2, e2))
    e1x5 = _add(_add(e1x3, e1), e1)
    tb = _sub(_add(e0x2, e2x4), _add(e1x5, e3))
    dev = e0.device
    ab = _mul(torch.stack((ta, tb)),
              torch.stack((mont_const(_SIX_INV, dev), mont_const(_TWO_INV, dev))))
    a, b = ab[0], ab[1]
    c = _sub(_sub(_sub(e1, e0), a), b)
    return torch.stack((e0, c, b, a))


def _horner4(cs, r):
    acc = cs[3]
    for k in (2, 1, 0):
        acc = _add(_mul(acc, r), cs[k])
    return acc


def round_transcript_plain(evals, coeffs, claim, sponge, poly_out, r_out) -> None:
    """Plain version of T1, in place. evals [3I, 8]: (e0, e2, e3) of each
    instance as S2 returns them; coeffs [I, 8]; claim [8], the running
    claim e. Forms c_t = sum_i coeffs_i * e_t,i and the cubic through (c0,
    e - c0, c2, c3), absorbs it as UniPoly.append_to_transcript does,
    squeezes "challenge_nextround" into ``r_out``, writes the coefficients
    (low to high) into ``poly_out`` [4, 8] and sets claim = poly(r) and the
    packed ``sponge`` to the state after the round."""
    I = coeffs.shape[0]
    rlc = F.fr.reduce_sum(_mul(evals.reshape(I, 3, NUM_LIMBS), coeffs.unsqueeze(1)), axis=0)
    c0, c2, c3 = rlc[0], rlc[1], rlc[2]
    cs = _cubic_from_evals(c0, _sub(claim, c0), c2, c3)
    tr = DynTranscript.from_sponge(sponge)
    tr.append_message(b"poly", b"UniPoly_begin")
    for b in frs_to_bytes_dev(cs):
        tr.append_message(b"coeff", b)
    tr.append_message(b"poly", b"UniPoly_end")
    r = tr.challenge_scalar(b"challenge_nextround")
    state, pos, pos_begin = tr.carry()
    sponge[:50].copy_(state.view(torch.int32))
    sponge[50] = pos.to(torch.int32)
    sponge[51] = pos_begin.to(torch.int32)
    claim.copy_(_horner4(cs, r))
    poly_out.copy_(cs)
    r_out.copy_(r)


def _check_t(name, t, shape, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"sc_transcript: {name} must be a contiguous, 16-byte aligned "
                         f"int32 {list(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def round_transcript(evals, coeffs, claim, sponge, poly_out, r_out) -> None:
    """One round's Fiat-Shamir step on the device (kernel T1), in place;
    the arguments as in ``round_transcript_plain``. ``r_out`` may be the
    tensor the next S1/S2 launch reads r from."""
    dev = coeffs.device
    if dev.type == "cpu":
        return round_transcript_plain(evals, coeffs, claim, sponge, poly_out, r_out)
    I = coeffs.shape[0]
    with K.timed("sc_transcript", "round", I, dev) as launch:
        for name, t, shape in (("evals", evals, (3 * I, NUM_LIMBS)),
                               ("coeffs", coeffs, (I, NUM_LIMBS)),
                               ("claim", claim, (NUM_LIMBS,)),
                               ("sponge", sponge, (SPONGE_WORDS,)),
                               ("poly_out", poly_out, (4, NUM_LIMBS)),
                               ("r_out", r_out, (NUM_LIMBS,))):
            _check_t(name, t, shape, dev)
        lib = K.lib("sc_transcript")
        rc = launch(lib.sc_transcript_launch, evals.data_ptr(), coeffs.data_ptr(), I,
                    claim.data_ptr(), sponge.data_ptr(), poly_out.data_ptr(),
                    r_out.data_ptr(), K.stream(dev))
        K.count("sc_transcript")
    K.check(rc, "sc_transcript")


__all__ = ["keccak_f1600_lanes", "keccak_f1600_state", "DynStrobe", "DynTranscript",
           "mont_const", "frs_to_bytes_dev", "bytes64_to_fr_mont", "pack_sponge",
           "unpack_sponge", "round_transcript", "round_transcript_plain", "SPONGE_WORDS"]
