"""What a prove encodes: the matrices once per instance, the witness once
per R1CS proof.

``SparseMatPolynomial`` keeps its device inputs (the values' Montgomery
limbs, the index arrays, the segment boundaries) on the host after their
first encode, so that ``release_device`` followed by the next use restores
them by a copy, without ``F.encode_fr`` or ``np.searchsorted``.
``R1CSProof.prove`` encodes the witness once and assembles z = (vars, 1,
inputs, 0...) from its limbs on the device. Every result is held to a
fresh instance's, and the proofs to fresh instances' bytes.
"""

import numpy as np
import pytest
import torch

from spartan_tpu_torch.core import sparse_mlpoly as SM
from spartan_tpu_torch.core.r1csproof import R1CSProof
from spartan_tpu_torch.io.keyless_bench import synthetic
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.snark import SNARK, NIZKGens, SNARKGens
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.serialization import serialize
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

P = F.FR.modulus


@pytest.fixture
def encodes(monkeypatch):
    """The values of every ``F.encode_fr`` call, in order."""
    seen = []
    real = F.encode_fr

    def counting(values, *args, **kwargs):
        if not isinstance(values, (list, tuple)):
            values = list(values)
        seen.append(values)
        return real(values, *args, **kwargs)

    monkeypatch.setattr(F, "encode_fr", counting)
    return seen


def _matrix(nnz: int, seed: int):
    """A 2^5 x 2^6 matrix of ``nnz`` entries; rows and columns repeat."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 32, size=nnz)
    cols = rng.integers(0, 64, size=nnz)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(nnz)]
    return (5, 6, rows, cols, vals)


def _outputs(M, z, e):
    return (M.multiply_vec_device(32, z), M.compute_eval_table_sparse_device(e, 64))


@pytest.mark.parametrize("nnz", [0, 1 << 8, 1 << 10])
def test_release_restores_from_host_copies(monkeypatch, nnz):
    args = _matrix(nnz, seed=nnz)
    rng = np.random.default_rng(1)
    z = F.encode_fr([int.from_bytes(rng.bytes(32), "little") % P for _ in range(64)],
                    device="cpu")
    e = F.encode_fr([int.from_bytes(rng.bytes(32), "little") % P for _ in range(32)],
                    device="cpu")
    want = _outputs(SM.SparseMatPolynomial.from_arrays(*args), z, e)
    M = SM.SparseMatPolynomial.from_arrays(*args)
    first = _outputs(M, z, e)
    host = dict(M._host), dict(M._bnd_host)
    calls = []
    monkeypatch.setattr(F, "encode_fr", lambda *a, **k: calls.append("encode_fr"))
    real_search = np.searchsorted
    monkeypatch.setattr(np, "searchsorted",
                        lambda *a, **k: calls.append("searchsorted") or real_search(*a, **k))
    for _ in range(2):
        M.release_device()
        assert not M._dev and not M._bnd_cache
        got = _outputs(M, z, e)
        for g, f, w in zip(got, first, want):
            assert torch.equal(g, w) and torch.equal(f, w)
    assert calls == []
    assert (dict(M._host), dict(M._bnd_host)) == host
    # both access orders' boundaries and every device input are kept
    assert len(M._bnd_host) == (2 if nnz else 0)
    assert set(M._host.get("cpu", {})) == ({"vals", "rows", "cols", "perm_r", "perm_c"}
                                           if nnz else set())


@pytest.mark.parametrize("log2,num_inputs", [(6, 1), (6, 10), (8, 1)])
def test_one_witness_encode_per_r1cs_proof(encodes, log2, num_inputs):
    inst, vars_, inputs, _ = synthetic(log2, num_inputs=num_inputs, seed=log2 + num_inputs)
    shape = inst.inst
    n = shape.num_vars
    gens = NIZKGens(n, n, num_inputs, device="cpu")
    # the matrices are the instance's, encoded before the witness's count
    for m in (shape.A, shape.B, shape.C):
        m.vals_device("cpu")
    encodes.clear()
    R1CSProof.prove(shape, vars_.assignment, inputs.assignment, gens.gens_r1cs_sat,
                    Transcript(b"t"), RandomTape(b"proof", seed=bytes([5]) * 32))
    # the other encodes of n values are the eq tables (host-built at
    # these sizes)
    assert [list(v) == vars_.assignment for v in encodes].count(True) == 1
    assert [len(v) for v in encodes].count(2 * n) == 0
    assert [list(v) == inputs.assignment for v in encodes].count(True) == 1


@pytest.mark.parametrize("num_inputs", [0, 1, 10])
def test_build_z_device_matches_host_encode(num_inputs):
    inst, vars_, inputs, _ = synthetic(5, num_inputs=num_inputs, seed=num_inputs)
    shape = inst.inst
    got = shape.build_z_device(F.encode_fr(vars_.assignment, device="cpu"),
                               F.encode_fr(inputs.assignment, device="cpu"))
    want = F.encode_fr(shape.build_z(vars_.assignment, inputs.assignment), device="cpu")
    assert got.dtype == want.dtype and torch.equal(got, want)


def _snark(pcs: str):
    inst, vars_, inputs, nnz = synthetic(3, seed=11)
    srs = None
    if pcs == "kzg":
        from spartan_tpu_torch.pcs.kzg import KZGSrs

        srs = KZGSrs.setup_from_seed(8 * 32 + 1, 11, device="cpu")
    n = inst.inst.num_cons
    gens = SNARKGens(n, n, 1, nnz, pcs=pcs, kzg_srs=srs, device="cpu")
    comm, decomm = SNARK.encode(inst, gens)
    return inst, comm, decomm, vars_, inputs, gens


def _prove(snark, seed: int) -> bytes:
    inst, comm, decomm, vars_, inputs, gens = snark
    proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(b"t"),
                        RandomTape(b"snark_proof", seed=bytes([seed]) * 32))
    return serialize(proof)


@pytest.mark.parametrize("pcs", ["hyrax", "kzg"])
def test_proves_after_release_match_fresh_instances(encodes, pcs):
    snark = _snark(pcs)
    A = snark[0].inst.A
    first = _prove(snark, 1)
    host = A._host["cpu"]
    encodes.clear()
    second = _prove(snark, 2)
    assert A._host["cpu"] is host
    # the second prove re-encodes no matrix values, only its witness
    mats = (A, snark[0].inst.B, snark[0].inst.C)
    assert not [v for v in encodes for m in mats if v is m.vals]
    assert sum(v is snark[3].assignment for v in encodes) == 1
    assert first == _prove(_snark(pcs), 1)
    assert second == _prove(_snark(pcs), 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pinned_host_copies_restore_on_the_card(cuda):
    """On the card the host copies are page-locked, and the restored device
    copies give the CPU's limbs (2^13 values: the encode's device route)."""
    args = _matrix(1 << 13, seed=13)
    rng = np.random.default_rng(2)
    z = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(64)]
    e = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(32)]
    want = _outputs(SM.SparseMatPolynomial.from_arrays(*args),
                    F.encode_fr(z, device="cpu"), F.encode_fr(e, device="cpu"))
    M = SM.SparseMatPolynomial.from_arrays(*args)
    M.vals_device(cuda)  # as the encode asks: ``cuda``, no index
    zc, ec = F.encode_fr(z, device=cuda), F.encode_fr(e, device=cuda)
    first = _outputs(M, zc, ec)  # tensors on ``cuda:0``: the same copies
    assert len(M._dev) == len(M._host) == 1
    M.release_device()
    again = _outputs(M, zc, ec)
    host = [t for h in M._host.values() for t in h.values()]
    host += [t for b in M._bnd_host.values() for t in b]
    assert len(host) == 5 + 4 and all(t.is_pinned() for t in host)
    for f, g, w in zip(first, again, want):
        assert torch.equal(f.cpu(), w) and torch.equal(g.cpu(), w)


def test_pickle_leaves_out_the_copies():
    """A pickled matrix carries its arrays, not this process's copies, and
    gives the same limbs once unpickled."""
    import pickle

    args = _matrix(1 << 8, seed=7)
    M = SM.SparseMatPolynomial.from_arrays(*args)
    z = F.encode_fr(list(range(64)), device="cpu")
    e = F.encode_fr(list(range(32)), device="cpu")
    want = _outputs(M, z, e)
    N = pickle.loads(pickle.dumps(M))
    assert not (N._dev or N._bnd_cache or N._host or N._bnd_host)
    assert M._host and M._bnd_host
    for g, w in zip(_outputs(N, z, e), want):
        assert torch.equal(g, w)
