"""Fused sumcheck round kernels S1-S4 and their plain PyTorch versions.

Counterpart of ``spartan_tpu/ops/pallas_sumcheck.py``. The JAX package
keeps two table layouts that suit TPU tiles (bit-reversed pairs, and a
``[4, n/4, 16]`` quarter layout); here every table stays in natural order,
``[n, 8]`` Montgomery limbs, and four hand-written CUDA kernels serve every
dispatch site of the sumcheck drivers:

* S1 ``csrc/sc_fold.cu`` ``fold``: k tables -> k half tables,
  ``out[i] = T[i] + r * (T[i + n/2] - T[i])`` (``bound_poly_var_top``);
* S2 ``csrc/sc_round_prod.cu`` ``prod_evals`` / ``prod_step``: the round
  evaluations (e0, e2, e3) of sum A*B*C for every instance of a batched
  round in one launch, either from the tables as they are or after folding
  them by r (an instance may instead read a C folded already: the eq table
  the "par" instances share);
* S3 ``csrc/sc_round_additive.cu`` ``additive_evals`` / ``additive_step``:
  the same for sum T*(A*B - C);
* S4 ``csrc/sc_round_quad.cu`` ``quad_evals`` / ``quad_step``: (e0, e2)
  of sum A*B;
* T2 ``csrc/sc_tail.cu`` ``prod_tail``: every remaining round of a batched
  product sumcheck on small tables in one launch (S2's evaluations, T1's
  Fiat-Shamir step of ``ops/transcript_device.py``, S1's fold, round after
  round), for the fused driver ``core/sumcheck_fused.py``.

A step's evaluations are those of the folded tables, i.e. of the next
round. The kernels write canonical per-block partial sums; the wrappers sum
them exactly with ``fr.reduce_sum`` (plain torch), as the JAX package sums
its kernels' partials outside them. Evaluations come back stacked
``[E * I, 8]`` (E = 3 or 2 per instance, in (e0, e2[, e3]) order), the
layout ``F.decode_fr`` reads.

On a CPU tensor every wrapper runs the plain version (built from the plain
field functions of ``ops/field.py``, independent of every kernel); on a
CUDA tensor it launches its kernel, counts the launch, and raises on a
refused launch. All arithmetic is exact mod p, so kernel and plain version
agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops import transcript_device as TD
from spartan_tpu_torch.ops.field import fr_add_plain as _add
from spartan_tpu_torch.ops.field import fr_mul_plain as _mul
from spartan_tpu_torch.ops.field import fr_sub_plain as _sub
from spartan_tpu_torch.ops.limbs import NUM_LIMBS

fr = F.fr

THREADS = 256        # threads per block of every S kernel
TOTAL_BLOCKS = 2048  # blocks per launch, shared among its instances
FOLD_MAX = 64        # tables per S1 launch (SC_FOLD_MAX)
PROD_MAX = 32        # instances per S2 launch (SC_PROD_MAX)
TAIL_MAX_CLUSTER = 16  # blocks of T2's cluster at most (SC_TAIL_MAX_CLUSTER)
TAIL_CLUSTER_N = 128   # T2 on tables of at least this many entries runs as a cluster


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _halves(T):
    """Low and high halves of tables [..., n, 8] (the top variable)."""
    h = T.shape[-2] // 2
    return T[..., :h, :], T[..., h:2 * h, :]


def _extrapolate(lo, hi):
    """Values at t = 2 and 3: 2hi - lo and 3hi - 2lo."""
    p2 = _sub(_add(hi, hi), lo)
    return p2, _sub(_add(p2, hi), lo)


def fold_plain(T, r):
    lo, hi = _halves(T)
    return _add(lo, _mul(r, _sub(hi, lo)))


def _prod_evals_stacked(A, B, C):
    """(e0, e2, e3) of each instance, [3I, 8], from stacked tables [I, n, 8]."""
    X = torch.stack((A, B, C))                            # [3, I, n, 8]
    lo, hi = _halves(X)
    p2, p3 = _extrapolate(lo, hi)
    pts = torch.stack((lo, p2, p3), dim=2)                # [3, I, 3, n/2, 8]
    return fr.reduce_sum(_mul(_mul(pts[0], pts[1]), pts[2]), axis=2).reshape(-1, NUM_LIMBS)


def prod_evals_plain(A, B, C):
    return _prod_evals_stacked(torch.stack(A), torch.stack(B), torch.stack(C))


def prod_step_plain(A, B, C, r, fold_c):
    A2 = [fold_plain(a, r) for a in A]
    B2 = [fold_plain(b, r) for b in B]
    C2 = [fold_plain(c, r) if f else None for c, f in zip(C, fold_c)]
    Ce = [c2 if f else c for c, c2, f in zip(C, C2, fold_c)]
    return A2, B2, C2, prod_evals_plain(A2, B2, Ce)


def prod_tail_plain(A, B, Cp, Cs, coeffs, claim, sponge, polys_out, rs_out):
    """Plain version of T2: round by round, ``prod_evals_plain``, T1's
    plain step, ``fold_plain`` of every table."""
    I = len(A)
    nP = I - len(Cs)
    T = torch.stack(list(A) + list(B) + [Cp] + list(Cs))  # [2I + 1 + nS, n, 8]
    for j in range(Cp.shape[0].bit_length() - 1):
        C = torch.cat((T[2 * I:2 * I + 1].expand(nP, -1, -1), T[2 * I + 1:]))
        ev = _prod_evals_stacked(T[:I], T[I:2 * I], C)
        TD.round_transcript_plain(ev, coeffs, claim, sponge, polys_out[j], rs_out[j])
        T = fold_plain(T, rs_out[j])
    return T[:, 0]


def additive_evals_plain(T, A, B, C):
    (tL, tH), (aL, aH), (bL, bH), (cL, cH) = (_halves(x) for x in (T, A, B, C))
    t2, t3 = _extrapolate(tL, tH)
    a2, a3 = _extrapolate(aL, aH)
    b2, b3 = _extrapolate(bL, bH)
    c2, c3 = _extrapolate(cL, cH)
    out = [fr.reduce_sum(_mul(t, _sub(_mul(a, b), c)), axis=0)
           for t, a, b, c in ((tL, aL, bL, cL), (t2, a2, b2, c2), (t3, a3, b3, c3))]
    return torch.stack(out, dim=0)


def additive_step_plain(T, A, B, C, r):
    folded = [fold_plain(x, r) for x in (T, A, B, C)]
    return (*folded, additive_evals_plain(*folded))


def quad_evals_plain(A, B):
    (aL, aH), (bL, bH) = _halves(A), _halves(B)
    a2 = _sub(_add(aH, aH), aL)
    b2 = _sub(_add(bH, bH), bL)
    return torch.stack((fr.reduce_sum(_mul(aL, bL), axis=0),
                        fr.reduce_sum(_mul(a2, b2), axis=0)), dim=0)


def quad_step_plain(A, B, r):
    A2, B2 = fold_plain(A, r), fold_plain(B, r)
    return A2, B2, quad_evals_plain(A2, B2)


# ---------------------------------------------------------------------------
# launch helpers
# ---------------------------------------------------------------------------

def _check(name: str, tables, n: int, device) -> None:
    for t in tables:
        F._check_limbs(name, t)
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name}: tables must all lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tables must be contiguous and 16-byte aligned")
        if t.shape != (n, NUM_LIMBS):
            raise ValueError(f"{name}: expected [{n}, {NUM_LIMBS}], got {tuple(t.shape)}")


def _check_r(name: str, r, device) -> None:
    F._check_limbs(name, r)
    if r.numel() != NUM_LIMBS or r.device != device or not r.is_contiguous():
        raise ValueError(f"{name}: r must be one contiguous element on the tables' device")


def _nblocks(work: int, inst: int) -> int:
    return max(1, min(-(-work // THREADS), TOTAL_BLOCKS // inst))


def _ptrs(tensors):
    """Host array of device pointers (0 for None) for a launch's arguments."""
    return (ctypes.c_ulonglong * len(tensors))(
        *[0 if t is None else t.data_ptr() for t in tensors])


def _empty(n: int, device):
    return torch.empty((n, NUM_LIMBS), dtype=torch.int32, device=device)


def _sum_partials(part):
    """[I, nblocks, E, 8] canonical partials -> [I * E, 8] exact sums."""
    return fr.reduce_sum(part, axis=1).reshape(-1, NUM_LIMBS)


# ---------------------------------------------------------------------------
# S1: fold
# ---------------------------------------------------------------------------

def fold(tables, r):
    """Fold every table [n, 8] by r: list of [n/2, 8] (kernel S1)."""
    tables = list(tables)
    if tables[0].device.type == "cpu":
        return [fold_plain(t, r) for t in tables]
    dev, n = tables[0].device, tables[0].shape[0]
    _check("sc_fold", tables, n, dev)
    _check_r("sc_fold", r, dev)
    h = n // 2
    outs = [_empty(h, dev) for _ in tables]
    if h == 0:
        return outs
    lib = K.lib("sc_fold")
    for s in range(0, len(tables), FOLD_MAX):
        grp_in, grp_out = tables[s:s + FOLD_MAX], outs[s:s + FOLD_MAX]
        with K.timed("sc_fold", "fold", len(grp_in) * n, dev) as launch:
            rc = launch(lib.sc_fold_launch, _ptrs(grp_in + grp_out), len(grp_in), r.data_ptr(),
                        h, _nblocks(h, len(grp_in)), K.stream(dev))
            K.count("sc_fold")
        K.check(rc, "sc_fold")
    return outs


# ---------------------------------------------------------------------------
# S2: batched product rounds
# ---------------------------------------------------------------------------

def _launch_prod(step: bool, A, B, C, r, fold_c):
    dev, n = A[0].device, A[0].shape[0]
    _check("sc_round_prod", list(A) + list(B), n, dev)
    I = len(A)
    if step:
        _check_r("sc_round_prod", r, dev)
        _check("sc_round_prod", [c for c, f in zip(C, fold_c) if f], n, dev)
        _check("sc_round_prod", [c for c, f in zip(C, fold_c) if not f], n // 2, dev)
        q = n // 4
        A2 = [_empty(n // 2, dev) for _ in range(I)]
        B2 = [_empty(n // 2, dev) for _ in range(I)]
        C2 = [_empty(n // 2, dev) if f else None for f in fold_c]
    else:
        _check("sc_round_prod", C, n, dev)
        q = n // 2
        A2 = B2 = C2 = None
    if q <= 0:
        raise ValueError(f"sc_round_prod: table of {n} entries is too short")
    lib = K.lib("sc_round_prod")
    evs = []
    for s in range(0, I, PROD_MAX):
        g = slice(s, min(s + PROD_MAX, I))
        m = g.stop - g.start
        with K.timed("sc_round_prod", "step" if step else "evals", m * n, dev) as launch:
            nb = _nblocks(q, m)
            part = torch.empty((m, nb, 3, NUM_LIMBS), dtype=torch.int32, device=dev)
            ptrs = list(A[g]) + list(B[g]) + list(C[g])
            if step:
                ptrs += A2[g] + B2[g] + C2[g]
            rc = launch(lib.sc_round_prod_launch, int(step), _ptrs(ptrs), m,
                        r.data_ptr() if step else None, q, nb, part.data_ptr(),
                        K.stream(dev))
            K.count("sc_round_prod")
        K.check(rc, "sc_round_prod")
        evs.append(_sum_partials(part))
    ev = torch.cat(evs, dim=0)
    return (A2, B2, C2, ev) if step else ev


def prod_evals(A, B, C):
    """Round evals of sum A_k*B_k*C_k per instance k, stacked [3I, 8]
    (kernel S2). C may repeat one shared table."""
    A, B, C = list(A), list(B), list(C)
    if A[0].device.type == "cpu":
        return prod_evals_plain(A, B, C)
    return _launch_prod(False, A, B, C, None, None)


def prod_step(A, B, C, r, fold_c):
    """Fold A_k, B_k (and C_k where ``fold_c[k]``; else C_k is folded
    already) by r, then the next round's evals (kernel S2).
    Returns (A', B', C' (None where not folded), evals [3I, 8])."""
    A, B, C, fold_c = list(A), list(B), list(C), list(fold_c)
    if A[0].device.type == "cpu":
        return prod_step_plain(A, B, C, r, fold_c)
    return _launch_prod(True, A, B, C, r, fold_c)


# ---------------------------------------------------------------------------
# T2: the small-table tail of a batched product sumcheck
# ---------------------------------------------------------------------------

def tail_cluster(n: int) -> int:
    """Blocks of T2's thread-block cluster for tables of n entries:
    TAIL_MAX_CLUSTER from TAIL_CLUSTER_N entries up, else one block (no
    cluster barrier). Chosen on the H100 with chip_smoke.py's sweep of
    every cluster size at every entry size (PERF.md): more blocks split a
    round's products further, and below ~2^7 entries the cluster barrier
    costs more than that saves."""
    return TAIL_MAX_CLUSTER if n >= TAIL_CLUSTER_N else 1


def prod_tail(A, B, Cp, Cs, coeffs, claim, sponge, polys_out, rs_out):
    """Every remaining round of a batched product sumcheck, in one launch
    (kernel T2): the instances' tables A_k, B_k [n, 8] (n = 2^rounds), the
    shared C ``Cp`` of the first I - len(Cs) instances and the own C of the
    rest; ``coeffs`` [I, 8] the layer coefficients. Round j's coefficients
    go to ``polys_out[j]`` [4, 8] and its challenge to ``rs_out[j]``;
    ``claim`` [8] and the packed ``sponge`` advance in place. The inputs are
    not changed (T2 folds a stacked copy; a cluster of ``tail_cluster(n)``
    blocks). Returns the final values [2I + 1 + len(Cs), 8]: A_k(r),
    B_k(r), Cp(r), then each own C(r)."""
    A, B, Cs = list(A), list(B), list(Cs)
    if Cp.device.type == "cpu":
        return prod_tail_plain(A, B, Cp, Cs, coeffs, claim, sponge, polys_out, rs_out)
    dev, n = Cp.device, Cp.shape[0]
    I, nS = len(A), len(Cs)
    rounds = n.bit_length() - 1
    if n != 1 << rounds or len(B) != I or nS > I:
        raise ValueError(f"sc_tail: {I} instances, {nS} own C, tables of {n} entries")
    tabs = A + B + [Cp] + Cs
    _check("sc_tail", tabs, n, dev)
    for name, t, shape in (("coeffs", coeffs, (I, NUM_LIMBS)), ("claim", claim, (NUM_LIMBS,)),
                           ("sponge", sponge, (TD.SPONGE_WORDS,)),
                           ("polys_out", polys_out, (rounds, 4, NUM_LIMBS)),
                           ("rs_out", rs_out, (rounds, NUM_LIMBS))):
        TD._check_t(name, t, shape, dev)
    with K.timed("sc_tail", f"tail x{len(tabs)}", n, dev) as launch:
        T = torch.stack(tabs)
        finals = _empty(len(tabs), dev)
        rc = launch(K.lib("sc_tail").sc_tail_launch, T.data_ptr(), len(tabs), n, I, I - nS,
                    coeffs.data_ptr(), claim.data_ptr(), sponge.data_ptr(),
                    polys_out.data_ptr(), rs_out.data_ptr(), finals.data_ptr(), rounds,
                    tail_cluster(n), K.stream(dev))
        K.count("sc_tail")
    K.check(rc, "sc_tail")
    return finals


# ---------------------------------------------------------------------------
# S3 / S4: the ZK sumchecks' rounds
# ---------------------------------------------------------------------------

def _launch_single(name: str, ne: int, step: bool, tables, r):
    dev, n = tables[0].device, tables[0].shape[0]
    _check(name, tables, n, dev)
    q = n // 4 if step else n // 2
    if q <= 0:
        raise ValueError(f"{name}: table of {n} entries is too short")
    outs = []
    if step:
        _check_r(name, r, dev)
        outs = [_empty(n // 2, dev) for _ in tables]
    with K.timed(name, "step" if step else "evals", n, dev) as launch:
        nb = _nblocks(q, 1)
        part = torch.empty((1, nb, ne, NUM_LIMBS), dtype=torch.int32, device=dev)
        lib = K.lib(name)
        rc = launch(getattr(lib, f"{name}_launch"), int(step), _ptrs(list(tables) + outs),
                    r.data_ptr() if step else None, q, nb, part.data_ptr(), K.stream(dev))
        K.count(name)
    K.check(rc, name)
    ev = _sum_partials(part)
    return (*outs, ev) if step else ev


def additive_evals(T, A, B, C):
    """Round evals (e0, e2, e3) of sum T*(A*B - C), [3, 8] (kernel S3)."""
    if T.device.type == "cpu":
        return additive_evals_plain(T, A, B, C)
    return _launch_single("sc_round_additive", 3, False, (T, A, B, C), None)


def additive_step(T, A, B, C, r):
    """Fold T, A, B, C by r, then the next round's evals (kernel S3).
    Returns (T', A', B', C', evals [3, 8])."""
    if T.device.type == "cpu":
        return additive_step_plain(T, A, B, C, r)
    return _launch_single("sc_round_additive", 3, True, (T, A, B, C), r)


def quad_evals(A, B):
    """Round evals (e0, e2) of sum A*B, [2, 8] (kernel S4)."""
    if A.device.type == "cpu":
        return quad_evals_plain(A, B)
    return _launch_single("sc_round_quad", 2, False, (A, B), None)


def quad_step(A, B, r):
    """Fold A, B by r, then the next round's evals (kernel S4).
    Returns (A', B', evals [2, 8])."""
    if A.device.type == "cpu":
        return quad_step_plain(A, B, r)
    return _launch_single("sc_round_quad", 2, True, (A, B), r)


__all__ = ["fold", "prod_evals", "prod_step", "prod_tail", "tail_cluster", "additive_evals",
           "additive_step",
           "quad_evals", "quad_step", "fold_plain", "prod_evals_plain", "prod_step_plain",
           "prod_tail_plain",
           "additive_evals_plain", "additive_step_plain", "quad_evals_plain",
           "quad_step_plain"]
