"""Error taxonomy.

Mirrors the reference's two error enums (reference src/errors.rs:5-31)
as Python exception types, so callers can catch the same failure classes.
"""

from __future__ import annotations


class SpartanError(Exception):
    """Base class for all spartan_tpu_torch errors."""


class R1CSError(SpartanError):
    """Errors constructing or checking an R1CS instance (errors.rs:5-17)."""


class InvalidIndexError(R1CSError):
    pass


class InvalidScalarError(R1CSError):
    pass


class InvalidNumberOfInputsError(R1CSError):
    pass


class NotSatisfiableError(R1CSError):
    pass


class InvalidDimensionsError(R1CSError):
    pass


class ProofVerifyError(SpartanError):
    """Proof verification failure (errors.rs:19-31).

    Carries a human-readable reason; protocol layers raise it with a
    claim-by-claim message like the reference's eprintln! diagnostics.
    """

    def __init__(self, reason: str = "internal error"):
        super().__init__(reason)
        self.reason = reason


def fmt_claims(**claims) -> str:
    """Claim-by-claim diagnostic dump for verify failures, mirroring the
    reference's eprintln! dumps (product_tree.rs:461-505,
    sparse_mlpoly_full.rs:1072-1108). Ints print as hex; lists are
    truncated to their first 8 entries."""

    def one(v):
        if isinstance(v, int):
            return hex(v)
        if isinstance(v, (list, tuple)):
            head = ", ".join(one(x) for x in list(v)[:8])
            more = f", ...{len(v) - 8} more" if len(v) > 8 else ""
            return f"[{head}{more}]"
        return repr(v)

    return "; ".join(f"{k}={one(v)}" for k, v in claims.items())
