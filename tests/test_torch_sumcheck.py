"""The port's sumcheck round kernels S1-S4 and its batched sumcheck.

The plain versions (what every wrapper runs on a CPU tensor) are held to
the JAX package's XLA composition (``spartan_tpu.core.sumcheck``), the
same functions ``tests/test_pallas_sumcheck.py`` holds the Pallas kernels
to, on the same numpy-seeded tables handed over through
``spartan_tpu_torch.interop``. ``prove_cubic_batched`` with its device
branch (host tail lowered) gives the JAX prover's round polynomials,
challenges and claims. The ``gpu`` cases hold each CUDA kernel to its plain
version. All arithmetic is exact mod p, so every comparison is equality.
The JAX package is imported inside the tests that use it, so the ``gpu``
tests run where JAX is not installed (``pytest -m gpu --noconftest``).
"""

import numpy as np
import pytest
import torch

from spartan_tpu_torch import interop
from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core.mle import DensePolynomial
from spartan_tpu_torch.core.sumcheck import SumcheckInstanceProof
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops import sumcheck_kernels as SK
from spartan_tpu_torch.ops.limbs import limbs_to_ints, to_tensor
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

P = F.FR.modulus
R = 1 << 256


def tables(seed: int, k: int, n: int, device="cpu"):
    """k Montgomery tables of n numpy-drawn field elements (0 and p - 1
    among them)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(k * n, 8), dtype=np.uint64).astype(np.uint32)
    xs = [v % P for v in limbs_to_ints(words)]
    xs[0], xs[1] = 0, P - 1
    mont = to_tensor(np.asarray([[(x * R % P) >> (32 * i) & 0xFFFFFFFF for i in range(8)]
                                 for x in xs], dtype=np.uint32), device)
    return list(mont.reshape(k, n, 8).unbind(0))


def scalar(x: int, device="cpu"):
    return F.encode_fr([x], device=device)[0]


def to_jax(t):
    import jax.numpy as jnp

    return jnp.asarray(interop.from_port(t))


def same(port, jax_arr) -> bool:
    return np.array_equal(interop.from_port(port), np.asarray(jax_arr))


R_CH = 0x1234567890ABCDEF1234567890ABCDEF


@pytest.mark.parametrize("n", [32, 64])
def test_fold_plain_matches_jax(n):
    from spartan_tpu.core import sumcheck as JSC

    (T,) = tables(1, 1, n)
    r = scalar(R_CH)
    (got,) = SK.fold([T], r)
    assert same(got, JSC.k_fold_top(to_jax(T), to_jax(r)))


@pytest.mark.parametrize("n", [32, 64])
def test_prod_plain_matches_jax(n):
    """evals only, fold + evals, and fold + evals against a shared C that
    is folded already."""
    import jax.numpy as jnp
    from spartan_tpu.core import sumcheck as JSC

    A, B, C = tables(2, 3, n)
    r = scalar(R_CH)
    jA, jB, jC, jr = (to_jax(x) for x in (A, B, C, r))
    assert same(SK.prod_evals([A], [B], [C]), jnp.stack(JSC.k_cubic_prod_evals(jA, jB, jC)))

    A2, B2, C2, ev = SK.prod_step([A], [B], [C], r, [True])
    fA, fB, fC = (JSC.k_fold_top(x, jr) for x in (jA, jB, jC))
    assert same(A2[0], fA) and same(B2[0], fB) and same(C2[0], fC)
    assert same(ev, jnp.stack(JSC.k_cubic_prod_evals(fA, fB, fC)))

    (Cf,) = SK.fold([C], r)
    A2, B2, C2, ev = SK.prod_step([A], [B], [Cf], r, [False])
    assert C2 == [None] and same(A2[0], fA) and same(B2[0], fB)
    assert same(ev, jnp.stack(JSC.k_cubic_prod_evals(fA, fB, fC)))


@pytest.mark.parametrize("n", [32, 64])
def test_additive_plain_matches_jax(n):
    from spartan_tpu.core import sumcheck as JSC

    T, A, B, C = tables(3, 4, n)
    r = scalar(R_CH)
    jt = [to_jax(x) for x in (T, A, B, C)]
    assert same(SK.additive_evals(T, A, B, C), JSC.k_cubic_additive_stack(*jt))
    *folded, ev = SK.additive_step(T, A, B, C, r)
    *jfolded, jev = JSC.k_step_cubic_additive(*jt, to_jax(r))
    assert all(same(a, b) for a, b in zip(folded, jfolded))
    assert same(ev, jev)


@pytest.mark.parametrize("n", [32, 64])
def test_quad_plain_matches_jax(n):
    from spartan_tpu.core import sumcheck as JSC

    A, B = tables(4, 2, n)
    r = scalar(R_CH)
    jA, jB = to_jax(A), to_jax(B)
    assert same(SK.quad_evals(A, B), JSC.k_quad_stack(jA, jB))
    A2, B2, ev = SK.quad_step(A, B, r)
    jA2, jB2, jev = JSC.k_step_quad(jA, jB, to_jax(r))
    assert same(A2, jA2) and same(B2, jB2) and same(ev, jev)


def test_batched_prod_plain_stacks_instances_in_order():
    """Two instances on a shared C and one with its own C: the evals come
    back [e0, e2, e3] per instance, in instance order."""
    A = tables(5, 3, 16)
    B = tables(6, 3, 16)
    C = tables(7, 2, 16)
    ev = SK.prod_evals(A, B, [C[0], C[0], C[1]])
    parts = [SK.prod_evals([a], [b], [c]) for a, b, c in zip(A, B, [C[0], C[0], C[1]])]
    assert torch.equal(ev, torch.cat(parts))


def test_prove_cubic_batched_matches_jax(monkeypatch):
    """The port's batched sumcheck on its device branch (S1/S2 plain
    versions, host tail only at 2 entries) gives the JAX prover's proof,
    challenges and claims on the same tables, coefficients and label."""
    from spartan_tpu.core import sumcheck as JSC
    from spartan_tpu.core.mle import DensePolynomial as JDP
    from spartan_tpu.utils.transcript import Transcript as JTranscript

    n, nP, nS = 32, 2, 2
    A = tables(8, nP + nS, n)
    B = tables(9, nP + nS, n)
    C = tables(10, nS + 1, n)
    coeffs = [3, 5, 7, 11]
    claim = 0
    for k in range(nP + nS):
        c = C[0] if k < nP else C[1 + k - nP]
        prod = F.fr.mul(F.fr.mul(A[k], B[k]), c)
        claim += coeffs[k] * F.decode_fr(F.fr.reduce_sum(prod, axis=0).unsqueeze(0))[0]

    def polys(make):
        return ((make(A[:nP]), make(B[:nP]), make(C[:1])[0]),
                (make(A[nP:]), make(B[nP:]), make(C[1:])))

    monkeypatch.setattr(HP, "HOST_N", 2)
    par, seq = polys(lambda ts: [DensePolynomial(t) for t in ts])
    proof, r, cp, cd = SumcheckInstanceProof.prove_cubic_batched(
        claim, 5, par, seq, coeffs, Transcript(b"batched"))
    jpar, jseq = polys(lambda ts: [JDP(to_jax(t)) for t in ts])
    jproof, jr, jcp, jcd = JSC.SumcheckInstanceProof.prove_cubic_batched(
        claim, 5, jpar, jseq, coeffs, JTranscript(b"batched"))
    assert r == jr
    assert [p.coeffs_except_linear_term for p in proof.compressed_polys] == \
        [p.coeffs_except_linear_term for p in jproof.compressed_polys]
    assert cp == (list(jcp[0]), list(jcp[1]), jcp[2]) and cd == tuple(list(x) for x in jcd)
    e, r2 = proof.verify(claim, 5, 3, Transcript(b"batched"))
    assert r2 == r


def test_wrappers_reject_bad_inputs():
    (T,) = tables(11, 1, 8)
    with pytest.raises(ValueError):
        SK._launch_single("sc_round_quad", 2, False, (T, T), None)  # CPU: no kernel
    if torch.cuda.is_available():
        t = T.cuda()
        with pytest.raises(ValueError):
            SK.quad_evals(t, t[:4])
        with pytest.raises(ValueError):
            SK.prod_step([t], [t], [t], scalar(1, "cuda"), [False])  # C not folded


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eq(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 64, 1 << 12])
def test_s1_s2_kernels_match_plain(cuda, n):
    """S1 over more tables than one launch takes; S2 in all three modes
    over more instances than one launch takes, shared and own C mixed."""
    I = SK.PROD_MAX + 3
    A, B, C = tables(12, I, n, cuda), tables(13, I, n, cuda), tables(14, I, n, cuda)
    r = scalar(R_CH, cuda)
    before = K.counts()
    assert _eq(SK.fold(A + B, r), [SK.fold_plain(t, r) for t in A + B])
    assert _eq(SK.prod_evals(A, B, C), SK.prod_evals_plain(A, B, C))
    fold_c = [k % 3 != 0 for k in range(I)]
    Cf = [c if f else SK.fold_plain(c, r) for c, f in zip(C, fold_c)]
    if n >= 4:
        assert _eq(SK.prod_step(A, B, Cf, r, fold_c), SK.prod_step_plain(A, B, Cf, r, fold_c))
    after = K.counts()
    assert after["sc_fold"] > before["sc_fold"]
    assert after["sc_round_prod"] > before["sc_round_prod"]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 64, 1 << 12])
def test_s3_s4_kernels_match_plain(cuda, n):
    T, A, B, C = tables(15, 4, n, cuda)
    r = scalar(R_CH, cuda)
    assert _eq(SK.additive_evals(T, A, B, C), SK.additive_evals_plain(T, A, B, C))
    assert _eq(SK.additive_step(T, A, B, C, r), SK.additive_step_plain(T, A, B, C, r))
    assert _eq(SK.quad_evals(A, B), SK.quad_evals_plain(A, B))
    assert _eq(SK.quad_step(A, B, r), SK.quad_step_plain(A, B, r))
