"""Canonical proof (de)serialization (arkworks CanonicalSerialize analog).

Walks proof objects structurally: field scalars as 32-byte LE, group
elements as 32-byte compressed points (flags in the top bits, matching
curve_host.compress), sequences length-prefixed with u32. Deterministic and
schema-driven by the dataclass field order, so sizes are directly
comparable with the reference's published proof sizes (BASELINE.md).

Deserialization is driven by the same schema: dataclass type annotations,
plus per-class ``SCHEMA`` overrides for untyped/polymorphic fields and
``DESER_SPECS`` for classes with a custom ``serialize_fields``. The
``pcs`` context selects the concrete class for runtime-polymorphic fields
(the reference resolves the same choice at compile time via the kzg
feature flag, snark.rs:403-404). No pickle anywhere — proofs are
adversarial input by design (CanonicalDeserialize semantics).
"""

from __future__ import annotations

import dataclasses
import struct
import typing


def serialize(obj) -> bytes:
    out = bytearray()
    _walk(obj, out)
    return bytes(out)


def save_proof(obj, path: str) -> None:
    """Persist a proof in the canonical byte format (no pickle)."""
    with open(path, "wb") as f:
        f.write(serialize(obj))


def load_proof(path: str, cls, pcs: str = "hyrax"):
    """Load + structurally validate a proof of type ``cls``.

    Raises ValueError on malformed bytes (out-of-range coordinates,
    truncation, trailing garbage). ``pcs`` resolves polymorphic fields
    (derefs commitment/proof) exactly like the prover's SNARKGens mode.
    """
    with open(path, "rb") as f:
        return deserialize(cls, f.read(), pcs=pcs)


def size_bytes(obj) -> int:
    return len(serialize(obj))


def _walk(obj, out: bytearray) -> None:
    from spartan_tpu_torch.core.group import GroupElem

    if isinstance(obj, GroupElem):
        out += obj.compress()
    elif isinstance(obj, bool):
        out += b"\x01" if obj else b"\x00"
    elif isinstance(obj, int):
        out += (obj % (1 << 256)).to_bytes(32, "little")
    elif isinstance(obj, bytes):
        out += struct.pack("<I", len(obj)) + obj
    elif isinstance(obj, (list, tuple)):
        out += struct.pack("<I", len(obj))
        for item in obj:
            _walk(item, out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _walk(getattr(obj, f.name), out)
    elif hasattr(obj, "serialize_fields"):
        for item in obj.serialize_fields():
            _walk(item, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


# ---------------------------------------------------------------------------
# deserialization
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated proof bytes")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]


_MAX_SEQ = 1 << 26  # sanity cap on length prefixes from untrusted bytes


def deserialize(cls_or_spec, data: bytes, pcs: str = "hyrax"):
    """Inverse of serialize for a known top-level type. Rejects trailing
    bytes (canonical encoding is exact)."""
    r = _Reader(data)
    obj = _read(cls_or_spec, r, {"pcs": pcs})
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after proof")
    return obj


def spec_for_type(tp):
    """typing annotation -> deserialization spec."""
    if tp is int:
        return "int"
    if tp is bool:
        return "bool"
    if tp is bytes:
        return "bytes"
    origin = typing.get_origin(tp)
    if origin is list:
        return ("vec", spec_for_type(typing.get_args(tp)[0]))
    if origin is tuple:
        return ("tuple", *[spec_for_type(a) for a in typing.get_args(tp)])
    if isinstance(tp, type) and tp not in (object, tuple, list):
        return tp
    raise TypeError(f"no deserialization spec for annotation {tp!r}")


def _read(spec, r: _Reader, ctx: dict):
    from spartan_tpu_torch.core.group import GroupElem

    if callable(spec) and not isinstance(spec, type):
        spec = spec(ctx)  # ctx-dependent (polymorphic) field
    if spec == "int":
        from spartan_tpu_torch.ops.fields_host import FR_MOD

        v = int.from_bytes(r.take(32), "little")
        # Scalar::from_bytes rejects non-canonical encodings (reference
        # scalar.rs:74-95, CanonicalDeserialize): without this, v and
        # v + p decode to the same verifier behavior (proof malleability)
        if v >= FR_MOD:
            raise ValueError("non-canonical scalar (>= field modulus)")
        return v
    if spec == "bool":
        b = r.take(1)[0]
        if b not in (0, 1):
            raise ValueError("invalid bool byte")
        return b == 1
    if spec == "bytes":
        n = r.u32()
        return r.take(n)
    if isinstance(spec, tuple) and spec and spec[0] == "vec":
        n = r.u32()
        if n > _MAX_SEQ:
            raise ValueError("sequence length prefix too large")
        return [_read(spec[1], r, ctx) for _ in range(n)]
    if isinstance(spec, tuple) and spec and spec[0] == "tuple":
        n = r.u32()
        if n != len(spec) - 1:
            raise ValueError(f"tuple arity mismatch: {n} != {len(spec) - 1}")
        return tuple(_read(s, r, ctx) for s in spec[1:])
    if isinstance(spec, type):
        if spec is GroupElem:
            try:
                return GroupElem.decompress(bytes(r.take(32)))
            except (ValueError, AssertionError) as e:
                raise ValueError(f"invalid compressed point: {e}") from e
        if dataclasses.is_dataclass(spec):
            hints = typing.get_type_hints(spec)
            schema = getattr(spec, "SCHEMA", {})
            vals = {}
            for f in dataclasses.fields(spec):
                fspec = schema.get(f.name)
                if fspec is None:
                    fspec = spec_for_type(hints[f.name])
                vals[f.name] = _read(fspec, r, ctx)
            return spec(**vals)
        deser = getattr(spec, "DESER_SPECS", None)
        if deser is not None:
            fields = [_read(s, r, ctx) for s in deser]
            return spec(*fields)
    raise TypeError(f"no deserializer for spec {spec!r}")
