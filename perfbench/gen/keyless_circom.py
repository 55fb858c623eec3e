"""A circom circuit with the Aptos Keyless circuit's published counts.

The circuit's own files are not public in this repository, so this makes
a stand-in of the same size and shape, in circom's binary format. It grows
``tools/make_circom_fixture.big_bytes`` (wire 0 the constant, wire 1 the
public input, then the private wires; each constraint ``(sum A) * (sum B)
= w`` defines a fresh private wire ``w`` from 2-4 terms in A and in B that
reuse earlier wires with a Zipf-like skew, coefficients from a pool of 64
values below 2^61) so that the counts come out exactly as the configuration
states them:

* the constraints that define no fresh wire (constraints minus private
  variables) are linear, ``(sum A) * 1 = (sum A)``: B is the constant wire
  and C repeats A's terms;
* A holds the most nonzeros of the three (``nnz_max``); the term counts of
  A and of B are drawn from {2, 3, 4} and then moved by one at random rows
  until A's total and the grand total (``nnz_total``) are met.

The circuit depends only on the configuration (``structure_seed``), so it
is written once into the cache directory and read back through the port's
circom reader. The witnesses depend on the run's seed: witness ``j`` has
its own public input, drawn from the seed and ``j``, and every private wire
evaluated forward from it. ``witness`` does that one wire at a time;
``witnesses`` does the same for many inputs at once, level by level of the
circuit, on the device.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
VERSION = 1


def _fix_sum(counts: np.ndarray, target: int, rng) -> None:
    """Move entries of ``counts`` (each in [2, 4]) by one until they sum to
    ``target``."""
    diff = int(target - counts.sum())
    if diff:
        room = np.flatnonzero(counts < 4) if diff > 0 else np.flatnonzero(counts > 2)
        if abs(diff) > len(room):
            raise ValueError("term counts cannot reach the configured total")
        counts[rng.choice(room, abs(diff), replace=False)] += 1 if diff > 0 else -1


def structure(config: dict) -> dict:
    """The circuit in circom's wire numbering: per matrix the constraint
    (row), wire (col) and coefficient of every term, in emission order."""
    n = config["num_constraints"]
    n_fresh = config["num_private_vars"]
    n_lin = n - n_fresh
    nnz_a = config["nnz_max"]
    rng = np.random.default_rng(config["structure_seed"])
    is_lin = np.zeros(n, dtype=bool)
    is_lin[rng.choice(n, n_lin, replace=False)] = True
    fresh = ~is_lin
    fresh_before = np.cumsum(fresh) - fresh
    avail = 2 + fresh_before

    a = rng.integers(2, 5, size=n)
    _fix_sum(a, nnz_a, rng)
    s_lin = int(a[is_lin].sum())
    b = np.ones(n, dtype=np.int64)
    b_fresh = rng.integers(2, 5, size=n_fresh)
    _fix_sum(b_fresh, config["nnz_total"] - nnz_a - n_lin - n_fresh - s_lin, rng)
    b[fresh] = b_fresh
    c = np.ones(n, dtype=np.int64)
    c[is_lin] = a[is_lin]

    pool = rng.integers(1, 1 << 61, size=64, dtype=np.int64)

    def skewed(rows):
        av = avail[rows]
        u = rng.random(len(rows))
        return np.minimum((av * u ** 4).astype(np.int64), av - 1)

    rows_a = np.repeat(np.arange(n), a)
    cols_a = skewed(rows_a)
    coef_a = pool[rng.integers(0, 64, size=len(rows_a))]

    rows_b = np.repeat(np.arange(n), b)
    lin_b = is_lin[rows_b]
    cols_b = skewed(rows_b)
    coef_b = pool[rng.integers(0, 64, size=len(rows_b))]
    cols_b[lin_b] = 0
    coef_b[lin_b] = 1

    rows_c = np.repeat(np.arange(n), c)
    cols_c = (2 + fresh_before[rows_c]).astype(np.int64)
    coef_c = np.ones(len(rows_c), dtype=np.int64)
    lin_c = is_lin[rows_c]
    start_a = np.cumsum(a) - a
    start_c = np.cumsum(c) - c
    pos = np.flatnonzero(lin_c)
    src = start_a[rows_c[pos]] + (pos - start_c[rows_c[pos]])
    cols_c[pos] = cols_a[src]
    coef_c[pos] = coef_a[src]
    return {"num_constraints": n, "num_wires": 2 + n_fresh, "is_lin": is_lin,
            "A": (rows_a, cols_a, coef_a), "B": (rows_b, cols_b, coef_b),
            "C": (rows_c, cols_c, coef_c)}


def witness(st: dict, pub: int) -> list[int]:
    """Every wire's value: 1, the public input, then each fresh wire."""
    w = [0] * st["num_wires"]
    w[0], w[1] = 1, pub % FR
    lists = []
    for key in ("A", "B"):
        rows, cols, coef = st[key]
        bounds = np.r_[0, np.cumsum(np.bincount(rows, minlength=st["num_constraints"]))]
        lists.append((bounds.tolist(), cols.tolist(), coef.tolist()))
    (ba, ca, va), (bb, cb, vb) = lists
    k = 2
    for i, lin in enumerate(st["is_lin"].tolist()):
        if lin:
            continue
        sa = 0
        for p in range(ba[i], ba[i + 1]):
            sa += va[p] * w[ca[p]]
        sb = 0
        for p in range(bb[i], bb[i + 1]):
            sb += vb[p] * w[cb[p]]
        w[k] = sa % FR * (sb % FR) % FR
        k += 1
    return w


# -- many witnesses at once: 16-bit limbs, Montgomery form with R = 2^384 --------

_RED = 24
_R = (1 << (16 * _RED)) % FR
_PINV = -pow(FR, -1, 1 << 16) % (1 << 16)


def _limbs(vals, n: int) -> np.ndarray:
    raw = b"".join(v.to_bytes(2 * n, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u2").astype(np.int64).reshape(-1, n)


def _carry(T):
    """The same value in 16-bit limbs; the top limb keeps what is left."""
    for j in range(T.shape[-1] - 1):
        T[..., j + 1] += T[..., j] >> 16
        T[..., j] &= 0xFFFF
    return T


def _mont(T, p):
    """T R^-1 mod FR as 16 limbs, for T < FR R held in non-negative limbs
    below 2^40 (42 of them)."""
    import torch

    T = T.clone()
    for i in range(_RED):
        m = ((T[..., i] & 0xFFFF) * _PINV) & 0xFFFF
        T[..., i:i + 16] += m.unsqueeze(-1) * p
        T[..., i + 1] += T[..., i] >> 16
    out = _carry(T[..., _RED:])[..., :17]
    d = out.clone()     # out < 2 FR: take out - FR where it leaves no borrow
    d[..., :16] -= p
    for j in range(16):
        d[..., j + 1] += d[..., j] >> 16
        d[..., j] &= 0xFFFF
    return torch.where(d[..., 16:17] < 0, out, d)[..., :16]


def _levels(st: dict, sides) -> np.ndarray:
    """Depth of each wire: 0 for the constant and the input, else one more
    than the deepest wire its constraint's A and B terms read."""
    fresh = ~st["is_lin"]
    wires = (2 + np.cumsum(fresh) - fresh)[fresh]
    lvl = np.zeros(st["num_wires"], dtype=np.int64)
    while True:
        new = lvl.copy()
        new[wires] = 1 + np.maximum(*(np.maximum.reduceat(lvl[cols], start)
                                      for cols, _, start, _ in sides))
        if (new == lvl).all():
            return lvl
        lvl = new


def witnesses(st: dict, pubs: list[int], device="cpu", chunk: int = 1 << 15) -> np.ndarray:
    """``witness`` of every public input in ``pubs`` at once, as canonical
    16-bit limbs: [len(pubs), num_wires, 16] uint16. All constraints of one
    depth are evaluated together on ``device``: the sums of A's and of B's
    terms with carries, their product reduced by Montgomery."""
    import torch

    dev = torch.device(device)
    n, fresh = st["num_constraints"], ~st["is_lin"]
    rows_f = np.flatnonzero(fresh)
    wires = (2 + np.cumsum(fresh) - fresh)[rows_f]
    sides = []
    for key in ("A", "B"):
        rows, cols, coef = st[key]
        keep = fresh[rows]
        counts = np.bincount(rows[keep], minlength=n)[rows_f]
        sides.append((cols[keep], coef[keep], np.cumsum(counts) - counts, counts))
    depth = _levels(st, sides)[wires]
    order = np.argsort(depth, kind="stable")
    cuts = np.searchsorted(depth[order], np.arange(1, depth.max(initial=0) + 2))
    p = torch.from_numpy(_limbs([FR], 16)[0]).to(dev)
    k = len(pubs)
    W = torch.zeros((st["num_wires"], k, 16), dtype=torch.int32, device=dev)
    W[0] = torch.from_numpy(_limbs([_R], 16)).to(dev)
    W[1] = torch.from_numpy(_limbs([x % FR * _R % FR for x in pubs], 16)).to(dev)
    dev_sides = [(torch.from_numpy(cols).to(dev),
                  torch.from_numpy(np.stack([(coef >> (16 * j)) & 0xFFFF for j in range(4)],
                                            axis=1)).to(dev))
                 for cols, coef, _, _ in sides]
    for l0, l1 in zip(cuts[:-1], cuts[1:]):
        for c0 in range(l0, l1, chunk):
            sel = order[c0:min(c0 + chunk, l1)]
            sums = []
            for (cols, coef), (_, _, start, cnt) in zip(dev_sides, sides):
                c = cnt[sel]
                first = np.cumsum(c) - c
                idx = torch.from_numpy(np.repeat(start[sel] - first, c)
                                       + np.arange(c.sum())).to(dev)
                w, cl = W[cols[idx]].long(), coef[idx]
                prod = torch.zeros((len(idx) + 1, k, 20), dtype=torch.int64, device=dev)
                for j in range(4):
                    prod[1:, :, j:j + 16] += cl[:, j, None, None] * w
                # each constraint's terms are contiguous: sums from a running total
                run = prod.cumsum_(0)
                ends = torch.from_numpy(np.cumsum(c)).to(dev)
                sums.append(_carry(run[ends] - run[ends - torch.from_numpy(c).to(dev)]))
            T = torch.zeros((len(sel), k, 42), dtype=torch.int64, device=dev)
            for i in range(20):
                T[..., i:i + 20] += sums[0][..., i:i + 1] * sums[1]
            W[torch.from_numpy(wires[sel]).to(dev)] = _mont(T, p).int()
    out = np.empty((k, st["num_wires"], 16), dtype="<u2")
    for w0 in range(0, st["num_wires"], chunk):
        T = torch.zeros((min(chunk, st["num_wires"] - w0), k, 42), dtype=torch.int64,
                        device=dev)
        T[..., :16] = W[w0:w0 + chunk]
        out[:, w0:w0 + chunk] = _mont(T, p).cpu().numpy().transpose(1, 0, 2)
    return out


class Pool:
    """The run's witnesses: item ``j`` is (public inputs, private values)."""

    def __init__(self, pubs: list[int], limbs: np.ndarray):
        self.pubs, self.limbs = pubs, limbs

    def __len__(self) -> int:
        return len(self.pubs)

    def __getitem__(self, j: int) -> tuple[list[int], list[int]]:
        raw = self.limbs[j, 2:].tobytes()
        return [self.pubs[j]], [int.from_bytes(raw[i:i + 32], "little")
                                for i in range(0, len(raw), 32)]


def public_input(seed: int, j: int) -> int:
    return int.from_bytes(hashlib.sha256(f"keyless-input/{seed}/{j}".encode()).digest(),
                          "little") % FR


def r1cs_bytes(st: dict) -> bytes:
    """The circuit as a circom ``.r1cs`` (version 1, sections 1-3)."""
    n, n_wires = st["num_constraints"], st["num_wires"]
    term = np.dtype([("w", "<u4"), ("c", "V32")])
    packed = []
    for key in ("A", "B", "C"):
        rows, cols, coef = st[key]
        t = np.zeros(len(rows), dtype=term)
        t["w"] = cols
        raw = np.zeros((len(rows), 32), dtype=np.uint8)
        raw[:, :8] = coef.astype("<u8").view(np.uint8).reshape(-1, 8)
        t["c"] = raw.view("V32").reshape(-1)
        counts = np.bincount(rows, minlength=n)
        packed.append((memoryview(t.tobytes()), np.r_[0, np.cumsum(counts)].tolist(),
                       counts.tolist()))
    body = []
    for i in range(n):
        for mv, bounds, counts in packed:
            body.append(struct.pack("<I", counts[i]))
            body.append(mv[36 * bounds[i]:36 * bounds[i + 1]])
    constraints = b"".join(body)
    header = (struct.pack("<I", 32) + FR.to_bytes(32, "little")
              + struct.pack("<IIII", n_wires, 0, 1, n_wires - 2)
              + struct.pack("<QI", n_wires, n))
    wire_map = np.arange(n_wires, dtype="<u8").tobytes()

    def section(kind: int, data: bytes) -> bytes:
        return struct.pack("<IQ", kind, len(data)) + data

    return (b"r1cs" + struct.pack("<II", 1, 3) + section(1, header)
            + section(2, constraints) + section(3, wire_map))


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def spartan_layout(st: dict, num_vars: int):
    """A, B, C as (rows, cols, vals) in Spartan's column layout: private
    wire w at w - 2, the constant at ``num_vars``, the input after it."""
    out = []
    for key in ("A", "B", "C"):
        rows, cols, coef = st[key]
        spartan = np.where(cols >= 2, cols - 2, num_vars + cols)
        out.append((rows, spartan, coef.tolist()))
    return tuple(out)


def build(config: dict, seed: int, cache_dir: str, witnesses_n: int = 1,
          device="cpu") -> dict:
    """The cached ``.r1cs``, a pool of ``witnesses_n`` witnesses of this seed
    (``Pool``), and what the reference needs: the matrices in Spartan's
    layout."""
    if config.get("num_public_inputs", 1) != 1:
        raise ValueError("the keyless stand-in has one public input")
    st = structure(config)
    key = hashlib.sha256(json.dumps(
        [VERSION] + [config[k] for k in ("num_constraints", "num_private_vars", "nnz_total",
                                         "nnz_max", "structure_seed")]).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"keyless_{key}.r1cs")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.partial"
        with open(tmp, "wb") as f:
            f.write(r1cs_bytes(st))
        os.replace(tmp, path)
    pubs = [public_input(seed, j) for j in range(witnesses_n)]
    num_vars = _pow2(max(st["num_wires"] - 2, 2))
    num_cons = _pow2(max(st["num_constraints"], 2))
    got = {"num_cons": num_cons, "num_vars": num_vars,
           "nnz_per_matrix": _pow2(max(len(st[k][0]) for k in ("A", "B", "C")))}
    if config.get("padded", got) != got:
        raise ValueError(f"padded to {got}, not as configured: {config['padded']}")
    return {"num_cons": num_cons, "num_vars": num_vars, "num_inputs": 1,
            "r1cs_path": path, "witnesses": Pool(pubs, witnesses(st, pubs, device)),
            "matrices": spartan_layout(st, num_vars),
            "counts": {"constraints": st["num_constraints"],
                       "private_vars": st["num_wires"] - 2,
                       "nnz": [len(st[k][0]) for k in ("A", "B", "C")]}}
