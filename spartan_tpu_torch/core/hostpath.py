"""Host-exact small-size fallback for the protocol layers.

The interactive protocol's tables halve every sumcheck round, so a prover
at size N touches ~log N distinct shapes per kernel; for the long tail of
tiny shapes, launch and transfer overhead dwarfs the math. Below the
thresholds here, table ops switch to exact Python bigint arithmetic, and
small MSMs to the host C backend — bit-identical results (all ops are
exact mod p on both paths) and microsecond dispatch.

The thresholds only decide WHERE work runs, never what the proof bytes
are. They are module attributes, read at call time, so tests can lower
them to drive the device-path code at small sizes:
  HOST_N              field-table ops up to this length (2048)
  HOST_MSM_N          MSM/commit sizes up to this (8192 with the native C
                      backend, else 128)
  HOST_COMMIT_POINTS  total points of a row-batched commit that stay on
                      the host (16384 with native C, else 512)
  HOST_BULLET_N       the prover's bullet rounds on a CUDA device run on
                      the card while the vectors are longer than this, and
                      on the host from here down (``bullet_on_host``)

The bullet reduction's prover (``core/bullet.py``) is the one place that
reads its own crossover: a round on the card is a few launches and two
small host trips, which beats the host C fold and MSMs down to lengths of
a few dozen, while on a CPU tensor the plain versions lose to the host C
at every length up to ``HOST_MSM_N``, so CPU rounds keep that threshold.
Commits, the Hyrax verify and the bullet verifier read ``HOST_MSM_N``.
"""

from __future__ import annotations

from spartan_tpu_torch.ops.fields_host import FR_MOD

HOST_N = 2048


def _default_msm_threshold() -> int:
    """With the native C G1 backend (native/g1_host.c) host MSMs run at
    tens of microseconds per point, so bullet rounds and small commits stay
    on the host up to 8192; the pure-Python fallback is ~25x slower, so it
    keeps only 128."""
    try:
        from spartan_tpu_torch import native as N

        return 8192 if N.g1_available else 128
    except Exception:
        return 128


HOST_MSM_N = _default_msm_threshold()

HOST_COMMIT_POINTS = 16384 if HOST_MSM_N >= 2048 else 512

HOST_BULLET_N = 32


def bullet_on_host(n: int, device) -> bool:
    """Whether a bullet round over vectors of length n on ``device`` runs on
    the host: at most ``HOST_BULLET_N`` on a card, at most the larger of
    ``HOST_BULLET_N`` and ``HOST_MSM_N`` elsewhere."""
    cut = HOST_BULLET_N if device.type == "cuda" else max(HOST_BULLET_N, HOST_MSM_N)
    return n <= cut


P = FR_MOD


# ---------------------------------------------------------------------------
# field table ops on python ints (canonical domain)
# ---------------------------------------------------------------------------

def fold_top(T: list[int], r: int) -> list[int]:
    """Z'[i] = Z[i] + r * (Z[i+n] - Z[i]) (hyrax.rs:195-203)."""
    n = len(T) // 2
    return [(T[i] + r * (T[i + n] - T[i])) % P for i in range(n)]


def cubic_prod_evals(A, B, C):
    """Round evals (e0, e2, e3) of sum A*B*C (sumcheck.rs:89-161)."""
    n = len(A) // 2
    e0 = e2 = e3 = 0
    for i in range(n):
        aL, aH = A[i], A[i + n]
        bL, bH = B[i], B[i + n]
        cL, cH = C[i], C[i + n]
        e0 += aL * bL % P * cL
        a2 = 2 * aH - aL
        b2 = 2 * bH - bL
        c2 = 2 * cH - cL
        e2 += a2 * b2 % P * c2
        e3 += (a2 + aH - aL) * (b2 + bH - bL) % P * (c2 + cH - cL)
    return e0 % P, e2 % P, e3 % P


def cubic_additive_evals(T, A, B, C):
    """Round evals of sum tau * (Az*Bz - Cz) (sumcheck.rs:465-530)."""
    n = len(T) // 2
    e0 = e2 = e3 = 0
    for i in range(n):
        tL, tH = T[i], T[i + n]
        aL, aH = A[i], A[i + n]
        bL, bH = B[i], B[i + n]
        cL, cH = C[i], C[i + n]
        e0 += tL * (aL * bL - cL) % P
        t2 = 2 * tH - tL
        a2 = 2 * aH - aL
        b2 = 2 * bH - bL
        c2 = 2 * cH - cL
        e2 += t2 * (a2 * b2 - c2) % P
        e3 += (t2 + tH - tL) * ((a2 + aH - aL) * (b2 + bH - bL) - (c2 + cH - cL)) % P
    return e0 % P, e2 % P, e3 % P


def quad_evals(A, B):
    """Round evals (e0, e2) of sum A*B (sumcheck.rs:684-699)."""
    n = len(A) // 2
    e0 = e2 = 0
    for i in range(n):
        e0 += A[i] * B[i]
        e2 += (2 * A[i + n] - A[i]) * (2 * B[i + n] - B[i])
    return e0 % P, e2 % P


def dot(a, b) -> int:
    return sum(x * y % P for x, y in zip(a, b)) % P


def mul_elementwise(a, b):
    return [x * y % P for x, y in zip(a, b)]


def eq_evals(r: list[int]) -> list[int]:
    """eq table, r[0] = most significant index bit (hyrax.rs:355-369)."""
    table = [1]
    for rj in r:
        nxt = []
        for t in table:
            h = t * rj % P
            nxt.append((t - h) % P)
            nxt.append(h)
        table = nxt
    return table


def evaluate_mle(Z: list[int], r: list[int]) -> int:
    """MLE evaluation by eq-table dot product (hyrax.rs:217-222)."""
    chis = eq_evals(r)
    return dot(chis[: len(Z)], Z)
