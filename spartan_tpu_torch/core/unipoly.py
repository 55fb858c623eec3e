"""Univariate sumcheck round polynomials (host-side, tiny).

Mirrors reference src/unipoly.rs: degree-2/3 polynomials interpolated
from evaluations at 0,1,2(,3) via the hardcoded inverse Vandermonde, with
the compressed form dropping the linear coefficient (reconstructed from the
hint e = p(0) + p(1), halving sumcheck proof size).
"""

from __future__ import annotations

from spartan_tpu_torch.ops.fields_host import FR_MOD, fr_inv


_TWO_INV = fr_inv(2)
_SIX_INV = fr_inv(6)


class UniPoly:
    """Coefficient form, low-to-high: c0 + c1 x + c2 x^2 (+ c3 x^3)."""

    def __init__(self, coeffs: list[int]):
        self.coeffs = [c % FR_MOD for c in coeffs]

    @staticmethod
    def from_evals(evals: list[int]) -> "UniPoly":
        """Interpolate from p(0), p(1), p(2) (,p(3)) (unipoly.rs:28-59)."""
        assert len(evals) in (3, 4)
        e = [v % FR_MOD for v in evals]
        if len(e) == 3:
            c = e[0]
            a = _TWO_INV * (e[2] - 2 * e[1] + c) % FR_MOD
            b = (e[1] - c - a) % FR_MOD
            return UniPoly([c, b, a])
        d = e[0]
        a = _SIX_INV * (e[3] - 3 * e[2] + 3 * e[1] - e[0]) % FR_MOD
        b = _TWO_INV * (2 * e[0] - 5 * e[1] + 4 * e[2] - e[3]) % FR_MOD
        c = (e[1] - d - a - b) % FR_MOD
        return UniPoly([d, c, b, a])

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def as_vec(self) -> list[int]:
        return list(self.coeffs)

    def eval_at_zero(self) -> int:
        return self.coeffs[0]

    def eval_at_one(self) -> int:
        return sum(self.coeffs) % FR_MOD

    def evaluate(self, r: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * r + c) % FR_MOD
        return acc

    def commit(self, blind: int, gens) -> "object":
        """Pedersen commit to the coefficient vector (unipoly.rs:89-97)."""
        from spartan_tpu_torch.core.commitments import commit as _commit

        return _commit(self.coeffs, blind, gens)

    def compress(self) -> "CompressedUniPoly":
        return CompressedUniPoly([self.coeffs[0]] + self.coeffs[2:])

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(label, b"UniPoly_begin")
        for c in self.coeffs:
            transcript.append_scalar(b"coeff", c)
        transcript.append_message(label, b"UniPoly_end")


class CompressedUniPoly:
    """Coefficients without the linear term (unipoly.rs:100-113)."""

    def __init__(self, coeffs_except_linear_term: list[int]):
        self.coeffs_except_linear_term = [c % FR_MOD for c in coeffs_except_linear_term]

    def decompress(self, hint: int) -> UniPoly:
        cs = self.coeffs_except_linear_term
        linear = (hint - 2 * cs[0] - sum(cs[1:])) % FR_MOD
        return UniPoly([cs[0], linear] + cs[1:])

    def serialized_scalars(self) -> list[int]:
        return list(self.coeffs_except_linear_term)

    def serialize_fields(self):
        return [self.coeffs_except_linear_term]

    DESER_SPECS = [("vec", "int")]
