"""The SpMV's exact segment sums (``core/sparse_mlpoly.segment_sums``).

The prefix sums run in chunks of at most ``_SEG_CHUNK`` terms; the chunk
is lowered here so that segments cross several chunk boundaries, one
segment is longer than a chunk and some are empty, and every sum is held
to host Python sums mod p.
"""

import numpy as np
import pytest
import torch

from spartan_tpu_torch.core import sparse_mlpoly as SM
from spartan_tpu_torch.ops import field as F

from torch_threads import _one_thread  # noqa: F401

P = F.FR.modulus


@pytest.mark.parametrize("chunk", [64, 1 << 24])
def test_segment_sums_cross_chunks(monkeypatch, chunk):
    monkeypatch.setattr(SM, "_SEG_CHUNK", chunk)
    rng = np.random.default_rng(3)
    n = 300
    xs = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n - 2)] + [P - 1, P - 1]
    prods = F.encode_fr(xs, device="cpu")
    # empty, short, one crossing 64 and 128, one longer than a chunk, the
    # last ending at n; and a segment of the whole table
    bounds = [(0, 0), (0, 5), (5, 5), (60, 130), (130, 290), (290, 300), (300, 300), (0, 300)]
    starts = torch.tensor([b[0] for b in bounds], dtype=torch.int64)
    ends = torch.tensor([b[1] for b in bounds], dtype=torch.int64)
    got = F.decode_fr(SM.segment_sums(prods, starts, ends))
    assert got == [sum(xs[s:e]) % P for s, e in bounds]


def test_multiply_vec_matches_host(monkeypatch):
    """M @ z through the SpMV with the chunk lowered: rows of 0 to 70
    entries, so row segments cross chunks of 16."""
    monkeypatch.setattr(SM, "_SEG_CHUNK", 16)
    rng = np.random.default_rng(4)
    rows = np.repeat(np.arange(8), [0, 3, 70, 1, 0, 17, 33, 2])
    cols = rng.integers(0, 16, size=rows.size)
    vals = [int(v) for v in rng.integers(1, 1 << 62, size=rows.size)]
    z = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(16)]
    M = SM.SparseMatPolynomial.from_arrays(3, 4, rows, cols, vals)
    got = F.decode_fr(M.multiply_vec(8, 16, z, device="cpu").Z)
    want = [0] * 8
    for r, c, v in zip(rows, cols, vals):
        want[r] = (want[r] + v * z[c]) % P
    assert got == want
