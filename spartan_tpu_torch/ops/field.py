"""Vectorized BN254 field arithmetic in PyTorch, on kernel H1.

Field elements are 8 little-endian 32-bit limbs in Montgomery form with
R = 2^256, stored as ``int32`` bit patterns ``[..., 8]`` (see
``ops/limbs.py``). ``mul``/``add``/``sub`` of both fields go through one
hand-written CUDA kernel, ``csrc/field_ew.cu`` (H1), which replaces the
JAX package's Pallas ``make_field_kernels`` mul/add/sub
(``spartan_tpu/ops/pallas_field.py:469-497``). Everything else here
(``sqr``, ``neg``, ``inv``, ``batch_inverse``, ``to_mont``/``from_mont``,
the log-step scans ``scan_mul``/``scan_add``) is composed from those
three, as ``spartan_tpu/ops/field_jax.py`` composes its own;
``reduce_sum`` is plain torch and exact mod p; ``host_inv`` inverts a few
elements on the host.

Plain versions
--------------
A CPU tensor goes to the plain PyTorch version of H1, a CUDA tensor to the
kernel. The plain version computes on 16 limbs of 16 bits held in int64
(CPU torch has no uint32 add, shift or compare):

* columns of a product are one batched outer product plus a skew-sum;
* ``_norm`` turns non-negative int64 columns into exact 16-bit limbs with a
  fixed number of carry passes and one carry-lookahead (``cummax`` over
  the positions that stop a carry), so no op count grows with the limbs;
* a Montgomery product a*b*R^-1 is the sum of the product's 16-bit column
  pieces times the precomputed constants 2^(16k) * R^-1 mod p, reduced by
  ``_reduce_cols``: a float64 estimate q of value/p (off by at most one),
  the exact value - q*p + p in [0, 3p), then two conditional subtracts.

Every step is exact, so the plain version and the kernel return the same
canonical limbs, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch.ops import fields_host as fh
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops.limbs import NUM_LIMBS, ints_to_limbs, limbs_to_ints, to_tensor

_M16 = 0xFFFF


class FieldSpec:
    """Per-field constants (host ints and 32-bit limb arrays)."""

    def __init__(self, modulus: int, name: str, code: int):
        self.name = name
        self.code = code  # field selector of the CUDA kernels
        self.modulus = modulus
        self.p_limbs = ints_to_limbs([modulus])[0]
        self.r1 = (1 << 256) % modulus    # Montgomery form of 1
        self.r2 = (self.r1 * self.r1) % modulus
        self.r1_limbs = ints_to_limbs([self.r1])[0]
        self.r2_limbs = ints_to_limbs([self.r2])[0]
        self.inv_exp = modulus - 2

    def __repr__(self):
        return f"FieldSpec({self.name})"


FR = FieldSpec(fh.FR_MOD, "Fr", 0)
FQ = FieldSpec(fh.FQ_MOD, "Fq", 1)


# ---------------------------------------------------------------------------
# plain version: exact arithmetic on 16-bit limbs in int64
# ---------------------------------------------------------------------------

def _limbs16(x: int, n: int) -> list[int]:
    return [(x >> (16 * i)) & _M16 for i in range(n)]


class _Consts:
    """Constant tensors of one field on one device (built once, cached)."""

    def __init__(self, spec: FieldSpec, device):
        p = spec.modulus
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
        self.p16 = t(_limbs16(p, 16))
        self.p19 = t(_limbs16(p, 19))
        self.np19 = t(_limbs16((1 << 304) - p, 19))
        # conditional subtracts: U + (2^256 - j p) carries out iff U >= j p
        self.npj = t([_limbs16((1 << 256) - j * p, 16) for j in (1, 2)])
        # b -> 2^256 - b is (0xFFFF - b_k) + [k == 0]
        self.one0 = t([1] + [0] * 15)
        # a multiple of p whose 16 columns are all >= 2^23: a + kred - b is
        # a non-negative column form of a - b for any b with columns < 2^23
        base = sum(1 << (23 + 16 * k) for k in range(16))
        m = -(-base // p)
        self.kred = t([(1 << 23) + d for d in _limbs16(m * p - base, 16)])
        rinv = pow(1 << 256, -1, p)
        ck = [_limbs16((1 << (16 * k)) * rinv % p, 16) for k in range(34)]
        # [31 * pieces, 16] float64: piece j of column k times C_(k+j); the
        # contraction is a float64 matmul, exact because every product is
        # below 2^32 and every sum below 2^39 < 2^53
        self.cc = {n: torch.tensor([ck[k + j] for k in range(31) for j in range(n)],
                                   dtype=torch.float64, device=device)
                   for n in (3, 4)}
        self.pow = torch.tensor([2.0 ** (16 * k) for k in range(19)],
                                dtype=torch.float64, device=device)
        self.pf = float(p)
        self.idx2 = 2 * torch.arange(40, dtype=torch.int64, device=device) + 2


_CONSTS: dict = {}


def _consts(spec: FieldSpec, device) -> _Consts:
    key = (spec.name, str(device))
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = _Consts(spec, device)
    return c


def _to16(a: torch.Tensor) -> torch.Tensor:
    """int32 [..., 8] -> int64 [..., 16] 16-bit limbs."""
    x = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((x & _M16, x >> 16), dim=-1).flatten(-2)


def _to32(a: torch.Tensor) -> torch.Tensor:
    """int64 [..., 16] 16-bit limbs -> int32 [..., 8] bit patterns."""
    v = a.unflatten(-1, (8, 2))
    w = v[..., 0] | (v[..., 1] << 16)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _passes(bits: int) -> int:
    """Carry passes that bring columns < 2^bits to at most 0x10000."""
    x, n = (1 << bits) - 1, 0
    while x > 0x10000:
        x = _M16 + (x >> 16)
        n += 1
    return n


def _norm(t: torch.Tensor, bits: int, C: _Consts):
    """Non-negative int64 columns (< 2^bits) -> (exact 16-bit limbs, top).

    ``top`` is whatever carries out of the last column. A few vectorized
    carry passes leave every column at most 0x10000; one carry-lookahead
    then resolves the remaining ripples: the carry into column k is the
    "generate" bit of the last column before k that does not merely
    propagate (i.e. is not 0xFFFF)."""
    top = 0
    for _ in range(_passes(bits)):
        hi = t >> 16
        top = top + hi[..., -1]
        t = (t & _M16) + TF.pad(hi[..., :-1], (1, 0))
    mark = torch.where(t == _M16, 0, C.idx2[:t.shape[-1]] + (t >> 16))
    cm = torch.cummax(mark, dim=-1).values
    out = (t + TF.pad(cm[..., :-1] & 1, (1, 0))) & _M16
    return out, top + (cm[..., -1] & 1)


def _cond_sub(U: torch.Tensor, C: _Consts, k: int) -> torch.Tensor:
    """Exact limbs U < (k+1)p (k in {1, 2}) -> U mod p."""
    X = U.unsqueeze(0) + C.npj[:k].view(k, *([1] * (U.dim() - 1)), 16)
    limbs, top = _norm(X, 17, C)
    out = U
    for j in range(k):
        out = torch.where(top[j].unsqueeze(-1) >= 1, limbs[j], out)
    return out


def _reduce_cols(V: torch.Tensor, C: _Consts, bits: int, qbits: int) -> torch.Tensor:
    """Non-negative columns V [..., K<=19] (< 2^bits) whose value is below
    2^qbits * p (qbits <= 40) -> canonical 16 limbs of V mod p."""
    kc = V.shape[-1]
    vf = (V.to(torch.float64) * C.pow[:kc]).sum(-1)
    q = torch.floor(vf / C.pf).to(torch.int64)  # floor(V/p) - 1, +0 or +1
    # V + p + q (2^304 - p) = (V - q p + p) + q 2^304, with V - q p + p in [0, 3p)
    W = TF.pad(V, (0, 19 - kc)) + C.p19 + q.unsqueeze(-1) * C.np19
    limbs, _ = _norm(W, max(bits, qbits + 16) + 2, C)
    return _cond_sub(limbs[..., :16], C, 2)


def lazy_reduce(x: torch.Tensor, C: _Consts, bits: int) -> torch.Tensor:
    """16 non-negative columns (< 2^bits, bits <= 40) -> canonical limbs."""
    return _reduce_cols(x, C, bits, max(1, bits - 12))


def lazy_sub(a: torch.Tensor, b: torch.Tensor, C: _Consts) -> torch.Tensor:
    """Columns congruent to a - b (b's columns < 2^23), all non-negative."""
    return a + C.kred - b


def lazy_mul(a: torch.Tensor, b: torch.Tensor, C: _Consts, bits: int) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p, canonical, from non-negative
    column forms of a and b (columns < 2^bits, bits <= 29).

    The 31 product columns are split into 16-bit pieces; piece j of column
    k weighs 2^(16(k+j)), so sum_kj piece * (2^(16(k+j)) R^-1 mod p) is
    congruent to a*b*R^-1 with small columns, reduced exactly."""
    outer = a.unsqueeze(-1) * b.unsqueeze(-2)                 # [..., 16, 16]
    sk = TF.pad(outer, (0, 16)).flatten(-2)[..., :496].unflatten(-1, (16, 31))
    T = sk.sum(-2)                                            # [..., 31]
    n = 3 if 2 * bits + 4 <= 48 else 4
    pieces = [T & _M16, (T >> 16) & _M16] + \
        ([T >> 32] if n == 3 else [(T >> 32) & _M16, T >> 48])
    pc = torch.stack(pieces, dim=-1).flatten(-2).to(torch.float64)
    V = torch.matmul(pc, C.cc[n]).to(torch.int64)             # V < 124 * 2^32
    return _reduce_cols(V, C, 39, 26)


def _add16(a, b, C):
    s = a + b
    limbs, top = _norm(torch.stack((s, s + C.npj[0])), 18, C)
    return torch.where(top[1].unsqueeze(-1) >= 1, limbs[1], limbs[0])


def _sub16(a, b, C):
    x = a + (_M16 - b) + C.one0          # a - b + 2^256
    limbs, top = _norm(torch.stack((x, x + C.p16)), 18, C)
    return torch.where(top[0].unsqueeze(-1) >= 1, limbs[0], limbs[1])


_OPS16 = {"mul": lambda a, b, C: lazy_mul(a, b, C, 16), "add": _add16, "sub": _sub16}
_PLAIN_CHUNK = 1 << 15  # bounds the [..., 16, 32] int64 product transients


def field_ew_plain(op: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch version of H1 (any device, broadcasting like H1)."""
    C = _consts(spec, a.device)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape).reshape(-1, NUM_LIMBS)
    b = b.expand(shape).reshape(-1, NUM_LIMBS)
    f = _OPS16[op]
    outs = [_to32(f(_to16(a[i:i + _PLAIN_CHUNK]), _to16(b[i:i + _PLAIN_CHUNK]), C))
            for i in range(0, a.shape[0], _PLAIN_CHUNK)]
    out = torch.cat(outs) if outs else a.new_empty((0, NUM_LIMBS))
    return out.reshape(shape)


def fr_mul_plain(a, b):
    """Fr product by H1's plain version (the kernels' plain versions)."""
    return field_ew_plain("mul", FR, a, b)


def fr_add_plain(a, b):
    return field_ew_plain("add", FR, a, b)


def fr_sub_plain(a, b):
    return field_ew_plain("sub", FR, a, b)


# ---------------------------------------------------------------------------
# kernel H1 (csrc/field_ew.cu)
# ---------------------------------------------------------------------------

_OP_CODE = {"mul": 0, "add": 1, "sub": 2}


def _check_limbs(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() < 1 or t.shape[-1] != NUM_LIMBS:
        raise ValueError(f"{name}: expected int32 [..., {NUM_LIMBS}], "
                         f"got {t.dtype} {tuple(t.shape)}")


def launch_field_ew(op: str, spec: FieldSpec, a: torch.Tensor, a_step: int,
                    b: torch.Tensor, b_step: int, n: int) -> torch.Tensor:
    """Launch H1 on n elements; an operand with step 0 is one element used
    for all n (stride-0 broadcast, no copy). Returns [n, 8]."""
    with K.timed("field_ew", f"{spec.name}.{op}", n, a.device) as launch:
        for name, t, step in (("a", a, a_step), ("b", b, b_step)):
            _check_limbs(name, t)
            if t.device.type != "cuda":
                raise ValueError(f"{name}: H1 runs on CUDA tensors only")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name}: must be contiguous and 16-byte aligned")
            if t.numel() != (n if step else 1) * NUM_LIMBS:
                raise ValueError(f"{name}: {t.numel() // NUM_LIMBS} elements for "
                                 f"n={n} with step {step}")
        if a.device != b.device:
            raise ValueError("operands on different devices")
        out = torch.empty((n, NUM_LIMBS), dtype=torch.int32, device=a.device)
        if n == 0:
            return out
        lib = K.lib("field_ew")
        rc = launch(lib.field_ew_launch, _OP_CODE[op], spec.code, a.data_ptr(), a_step,
                    b.data_ptr(), b_step, out.data_ptr(), n, K.stream(a.device))
        K.count("field_ew")
    K.check(rc, "field_ew")
    return out


def _operand(t: torch.Tensor, shape) -> tuple[torch.Tensor, int]:
    if t.numel() == NUM_LIMBS:
        return t.reshape(NUM_LIMBS).contiguous(), 0
    if tuple(t.shape) != tuple(shape):
        t = t.expand(shape)
    return t.contiguous(), 1


def field_ew(op: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Elementwise ``op`` in {mul, add, sub} with broadcasting."""
    _check_limbs("a", a)
    _check_limbs("b", b)
    if a.device != b.device:
        raise ValueError("operands on different devices")
    if a.device.type == "cpu":
        return field_ew_plain(op, spec, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = 1
    for s in shape[:-1]:
        n *= s
    a2, sa = _operand(a, shape)
    b2, sb = _operand(b, shape)
    return launch_field_ew(op, spec, a2, sa, b2, sb, n).reshape(shape)


# ---------------------------------------------------------------------------
# exact field sums (plain torch on every device)
# ---------------------------------------------------------------------------

_SUM_CHUNK = 1 << 24  # terms per int64 column sum (columns < 2^40)


def reduce_columns(cols: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Non-negative int64 16-bit-base columns [..., 16] whose value is a
    sum of at most 2^24 canonical elements -> canonical int32 [..., 8]."""
    C = _consts(spec, cols.device)
    return _to32(_reduce_cols(cols, C, 41, 25))


def make_ops(spec: FieldSpec):
    """Op suite of one field; ``mul``/``add``/``sub`` are H1."""

    class Ops:
        pass

    ops = Ops()
    ops.spec = spec

    def mul(a, b):
        return field_ew("mul", spec, a, b)

    def add(a, b):
        return field_ew("add", spec, a, b)

    def sub(a, b):
        return field_ew("sub", spec, a, b)

    def sqr(a):
        return mul(a, a)

    def zeros(batch_shape=(), device=None):
        dev = DEV.current() if device is None else device
        return torch.zeros((*batch_shape, NUM_LIMBS), dtype=torch.int32, device=dev)

    def const(limbs, batch_shape=(), device=None):
        dev = DEV.current() if device is None else device
        one = to_tensor(limbs, dev)
        return one.expand((*batch_shape, NUM_LIMBS)).contiguous()

    def ones_mont(batch_shape=(), device=None):
        return const(spec.r1_limbs, batch_shape, device)

    def neg(a):
        return sub(zeros((), a.device), a)

    def is_zero(a):
        return (a == 0).all(dim=-1)

    def eq(a, b):
        return (a == b).all(dim=-1)

    def to_mont(a):
        return mul(a, const(spec.r2_limbs, (), a.device))

    def from_mont(a):
        one = np.zeros(NUM_LIMBS, np.uint32)
        one[0] = 1
        return mul(a, const(one, (), a.device))

    def inv(a):
        """Fermat inverse of Montgomery-form input (0 -> 0). Batched."""
        e = spec.inv_exp
        acc = ones_mont(a.shape[:-1], a.device)
        for i in range(e.bit_length() - 1, -1, -1):
            acc = sqr(acc)
            if (e >> i) & 1:
                acc = mul(acc, a)
        return torch.where(is_zero(a).unsqueeze(-1), torch.zeros_like(a), acc)

    def _scan(op, x, reverse: bool):
        """Inclusive scan of ``op`` along axis 0 (log-step, exact)."""
        if reverse:
            return _scan(op, x.flip(0), False).flip(0)
        n = x.shape[0]
        stride = 1
        while stride < n:
            x = torch.cat((x[:stride], op(x[:n - stride], x[stride:])), dim=0)
            stride *= 2
        return x

    def _scan_mul(x, reverse: bool = False):
        """Inclusive prefix products along axis 0 (suffix products if reverse)."""
        return _scan(mul, x, reverse)

    def _scan_add(x, reverse: bool = False):
        """Inclusive prefix sums along axis 0 (suffix sums if reverse), on H1 add."""
        return _scan(add, x, reverse)

    def host_inv(a):
        """``inv`` on the host: one device-to-host read of a, a Python
        inverse of each element and one upload, in place of the ~380 H1
        launches of the Fermat ladder. For a few elements."""
        vals = limbs_to_ints(a.detach().to("cpu").reshape(-1, NUM_LIMBS).numpy())
        p = spec.modulus
        out = [pow(v, -1, p) * spec.r2 % p if v else 0 for v in vals]
        return to_tensor(ints_to_limbs(out), a.device).reshape(a.shape)

    def batch_inverse(a, host: bool = False):
        """Inverse along axis 0 via Montgomery's trick (zeros -> zeros); the
        one inverse of the product by ``host_inv`` if ``host``, else by
        ``inv`` on the tensor's device."""
        zero_mask = is_zero(a).unsqueeze(-1)
        one = ones_mont(a.shape[1:-1], a.device).unsqueeze(0)
        safe = torch.where(zero_mask, one, a)
        pre = _scan_mul(safe)
        suf = _scan_mul(safe, reverse=True)
        total_inv = (host_inv if host else inv)(pre[-1])
        left = torch.cat((one, pre[:-1]), dim=0)
        right = torch.cat((suf[1:], one), dim=0)
        out = mul(mul(left, right), total_inv)
        return torch.where(zero_mask, torch.zeros_like(a), out)

    def reduce_sum(a, axis=0):
        """Exact field sum along one axis (Montgomery-domain linear)."""
        a = torch.movedim(a, axis, 0)
        if a.shape[0] == 0:
            return zeros(a.shape[1:-1], a.device)
        while True:
            n = a.shape[0]
            parts = [reduce_columns(_to16(a[i:i + _SUM_CHUNK]).sum(0), spec)
                     for i in range(0, n, _SUM_CHUNK)]
            if len(parts) == 1:
                return parts[0]
            a = torch.stack(parts, dim=0)

    ops.mul, ops.add, ops.sub, ops.sqr, ops.neg = mul, add, sub, sqr, neg
    ops.is_zero, ops.eq = is_zero, eq
    ops.zeros, ops.one = zeros, ones_mont
    ops.to_mont, ops.from_mont = to_mont, from_mont
    ops.inv, ops.host_inv = inv, host_inv
    ops.batch_inverse, ops.reduce_sum = batch_inverse, reduce_sum
    ops.scan_mul, ops.scan_add = _scan_mul, _scan_add
    return ops


fr = make_ops(FR)
fq = make_ops(FQ)


# ---------------------------------------------------------------------------
# host <-> device conversion (Montgomery domain on device)
# ---------------------------------------------------------------------------

# Up to this many elements, Montgomery conversion runs on the host (the C
# backend, else Python bigints); above it, one H1 multiply by R^2 (or 1)
# on the device. Routes work only: the limbs are the same either way.
_HOST_CONVERT_N = 1 << 12
_R256 = 1 << 256


def _native_fr_mont():
    from spartan_tpu_torch import native as N

    return N if N.g1_available else None


def encode_fr(values, spec: FieldSpec = FR, device=None) -> torch.Tensor:
    """Python ints -> [n, 8] Montgomery limbs on ``device`` (or current)."""
    dev = DEV.current() if device is None else torch.device(device)
    vals = [v % spec.modulus for v in values]
    if len(vals) <= _HOST_CONVERT_N:
        N = _native_fr_mont() if spec is FR else None
        if N is not None and vals:
            raw = N.fr_batch_mont(b"".join(v.to_bytes(32, "little") for v in vals),
                                  len(vals), True)
            host = np.frombuffer(raw, dtype="<u4").reshape(len(vals), NUM_LIMBS)
            return to_tensor(host, dev)
        return to_tensor(ints_to_limbs([v * _R256 % spec.modulus for v in vals]), dev)
    ops = fr if spec is FR else fq
    return ops.to_mont(to_tensor(ints_to_limbs(vals), dev))


def decode_fr(arr: torch.Tensor, spec: FieldSpec = FR) -> list[int]:
    """[..., 8] Montgomery limbs -> canonical Python ints (flattened)."""
    count = arr.numel() // NUM_LIMBS
    if count == 0:
        return []
    if count <= _HOST_CONVERT_N:
        host = arr.detach().to("cpu").contiguous().reshape(count, NUM_LIMBS).numpy()
        N = _native_fr_mont() if spec is FR else None
        if N is not None:
            raw = N.fr_batch_mont(host.astype("<i4").tobytes(), count, False)
            return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
                    for i in range(count)]
        rinv = pow(_R256, -1, spec.modulus)
        return [x * rinv % spec.modulus for x in limbs_to_ints(host)]
    ops = fr if spec is FR else fq
    canon = ops.from_mont(arr.reshape(count, NUM_LIMBS))
    return limbs_to_ints(canon.to("cpu").numpy())


def encode_small_uints(values, spec: FieldSpec = FR, device=None) -> torch.Tensor:
    """Non-negative ints below 2^63 (numpy array or list) -> [n, 8]
    Montgomery limbs on ``device``: the two low limbs are set on the
    device, then one multiply by R^2 (H1 on a card). No Python ints, for
    the index and timestamp tables of the lookup argument."""
    dev = DEV.current() if device is None else torch.device(device)
    v = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64)).to(dev)
    canon = torch.zeros((v.shape[0], NUM_LIMBS), dtype=torch.int32, device=dev)
    lo = v & 0xFFFFFFFF
    canon[:, 0] = (lo - ((lo >> 31) << 32)).to(torch.int32)
    canon[:, 1] = (v >> 32).to(torch.int32)
    return (fr if spec is FR else fq).to_mont(canon)


def encode_canonical(values, device=None) -> torch.Tensor:
    """Python ints (already reduced) -> [n, 8] canonical (non-Montgomery)
    limbs, the scalar form the MSM takes."""
    dev = DEV.current() if device is None else torch.device(device)
    return to_tensor(ints_to_limbs(values), dev)


def encode_fq(values, device=None) -> torch.Tensor:
    return encode_fr(values, FQ, device)


def decode_fq(arr) -> list[int]:
    return decode_fr(arr, FQ)


__all__ = ["FR", "FQ", "FieldSpec", "fr", "fq", "field_ew", "field_ew_plain",
           "fr_mul_plain", "fr_add_plain", "fr_sub_plain",
           "launch_field_ew", "encode_fr", "decode_fr", "encode_fq", "decode_fq",
           "encode_small_uints", "encode_canonical", "reduce_columns"]
