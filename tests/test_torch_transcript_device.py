"""The port's device transcript and fused sumcheck tail on the CPU.

Every case runs the plain versions (what T1 and T2 run on a CPU tensor)
and holds them to the port's host transcript, to ``utils/strobe.py``, or
to ``spartan_tpu``'s batched product sumcheck (at 2^13 and 2^14 entries to
a replay of its rounds on the host integer functions): the cases of
``tests/test_transcript_device.py`` on the port. The ``gpu`` cases hold the
kernels T1 and T2 to their plain versions. All arithmetic is exact, so
every comparison is equality. The JAX package is imported inside the
function that uses it.
"""

import secrets

import numpy as np
import pytest
import torch

from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core import sumcheck_fused as SF
from spartan_tpu_torch.core.mle import DensePolynomial
from spartan_tpu_torch.core.sumcheck import SumcheckInstanceProof
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import kernels as K
from spartan_tpu_torch.ops import sumcheck_kernels as SK
from spartan_tpu_torch.ops import transcript_device as TD
from spartan_tpu_torch.ops.keccak import _keccak_f1600_bytes_py
from spartan_tpu_torch.utils.strobe import Strobe128
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

P = F.FR.modulus


def _u8(b: bytes) -> torch.Tensor:
    return torch.tensor(list(b), dtype=torch.uint8)


def test_keccak_f1600_matches_host():
    rng = np.random.default_rng(7)
    st = rng.integers(0, 256, (4, 200)).astype(np.uint8)
    got = TD.keccak_f1600_lanes(torch.from_numpy(st.copy()).view(torch.int64))
    for k in range(4):
        ref = bytearray(st[k].tobytes())
        _keccak_f1600_bytes_py(ref)
        assert bytes(got[k].contiguous().view(torch.uint8).tolist()) == bytes(ref)
    one = TD.keccak_f1600_state(torch.from_numpy(st[0].copy()))
    assert torch.equal(one, got[0].contiguous().view(torch.uint8))


@pytest.mark.parametrize("tensor_data", [False, True])
def test_strobe_matches_host(tensor_data):
    """The tensor-position strobe against utils/strobe.py, with the
    absorbed data given as bytes or as a uint8 tensor."""
    rng = np.random.default_rng(11 + tensor_data)
    h = Strobe128(b"Merlin v1.0")
    d = TD.DynStrobe(_u8(bytes(h.state)), h.pos, h.pos_begin)
    for _ in range(40):
        op = rng.integers(0, 3)
        data = secrets.token_bytes(int(rng.integers(1, 150)))
        ddata = _u8(data) if tensor_data else data
        if op == 0:
            h.meta_ad(data, False)
            d.meta_ad_op(ddata)
        elif op == 1:
            h.ad(data, False)
            d.ad_op(ddata)
        else:
            n = int(rng.integers(1, 100))
            assert h.prf(n, False) == bytes(d.prf(n).tolist())
    assert bytes(h.state) == bytes(d.state.tolist())
    assert h.pos == int(d.pos)
    assert h.pos_begin == int(d.pos_begin)


def test_challenge_scalar_matches_host():
    t = Transcript(b"device parity")
    dt = TD.DynTranscript.from_sponge(TD.pack_sponge(t, "cpu"))
    s = 98765432123456789 ** 3 % P
    t.append_scalar(b"sc", s)
    dt.append_message(b"sc", TD.frs_to_bytes_dev(F.encode_fr([s], device="cpu"))[0])
    t.append_message(b"m", b"hello")
    dt.append_message(b"m", b"hello")
    assert t.challenge_scalar(b"ch") == F.decode_fr(dt.challenge_scalar(b"ch")[None])[0]
    state, pos, pos_begin = dt.carry()
    assert bytes(t.strobe.state) == bytes(state.tolist())
    assert (t.strobe.pos, t.strobe.pos_begin) == (int(pos), int(pos_begin))
    # 64 bytes of 0xFF: both halves above 5p, reduced as from_le_bytes_mod_order
    ff = _u8(b"\xff" * 64)
    assert F.decode_fr(TD.bytes64_to_fr_mont(ff)[None])[0] == ((1 << 512) - 1) % P


def test_round_step_packs_sponge():
    """T1's plain step on the packed sponge leaves the host transcript's
    state after the same round, and r is the host's challenge."""
    t = Transcript(b"round")
    t.append_message(b"x", b"y" * 150)   # a position that makes the round cross blocks
    sponge = TD.pack_sponge(t, "cpu")
    rng = np.random.default_rng(5)
    I = 3
    ev = [int(v) % P for v in rng.integers(1, 1 << 62, size=3 * I)]
    co = [int(v) % P for v in rng.integers(1, 1 << 62, size=I)]
    e = 123456789
    evals, coeffs = F.encode_fr(ev, device="cpu"), F.encode_fr(co, device="cpu")
    claim = F.encode_fr([e], device="cpu")[0].clone()
    poly, r = torch.zeros((4, 8), dtype=torch.int32), torch.zeros(8, dtype=torch.int32)
    TD.round_transcript_plain(evals, coeffs, claim, sponge, poly, r)

    from spartan_tpu_torch.core.unipoly import UniPoly

    c = [sum(ev[3 * i + k] * co[i] for i in range(I)) % P for k in range(3)]
    up = UniPoly.from_evals([c[0], (e - c[0]) % P, c[1], c[2]])
    up.append_to_transcript(b"poly", t)
    r_host = t.challenge_scalar(b"challenge_nextround")
    assert F.decode_fr(poly) == up.coeffs
    assert F.decode_fr(r[None])[0] == r_host
    assert F.decode_fr(claim[None])[0] == up.evaluate(r_host)
    assert TD.unpack_sponge(sponge) == (bytes(t.strobe.state), t.strobe.pos, t.strobe.pos_begin)


def _instance(n, nP, nS):
    rng = np.random.default_rng(n + nP)

    def dpoly():
        return DensePolynomial(F.encode_small_uints(
            rng.integers(1, 1 << 32, size=n, dtype=np.uint64).astype(np.int64), device="cpu"))

    A = [dpoly() for _ in range(nP + nS)]
    B = [dpoly() for _ in range(nP + nS)]
    Cp = dpoly()
    Cs = [dpoly() for _ in range(nS)]
    claim = int(rng.integers(1, 1 << 60))
    coeffs = [int(rng.integers(1, 1 << 60)) for _ in range(nP + nS)]
    return A, B, Cp, Cs, claim, coeffs


def _prove(n, nP, nS, label=b"fused equiv"):
    A, B, Cp, Cs, claim, coeffs = _instance(n, nP, nS)
    tr = Transcript(label)
    res = SumcheckInstanceProof.prove_cubic_batched(
        claim, n.bit_length() - 1, (A[:nP], B[:nP], Cp), (A[nP:], B[nP:], Cs), coeffs, tr)
    return res, tr


def _sponge(transcript):
    s = transcript.strobe
    return bytes(s.state), s.pos, s.pos_begin


def _claims(claims_prod, claims_dotp):
    (ap, bp, cp), (ad, bd, cd) = claims_prod, claims_dotp
    return [int(v) for v in (*ap, *bp, cp, *ad, *bd, *cd)]


def _jax_reference(n, nP, nS, label):
    """spartan_tpu's prove_cubic_batched on the same tables: round
    polynomials, challenges, claims and final sponge."""
    import jax.numpy as jnp

    from spartan_tpu.core import sumcheck as JSC
    from spartan_tpu.core.mle import DensePolynomial as JDP
    from spartan_tpu.utils.transcript import Transcript as JTranscript
    from spartan_tpu_torch import interop

    A, B, Cp, Cs, claim, coeffs = _instance(n, nP, nS)

    def j(ps):
        return [JDP(jnp.asarray(interop.from_port(p.Z))) for p in ps]

    tr = JTranscript(label)
    proof, r, cp, cd = JSC.SumcheckInstanceProof.prove_cubic_batched(
        claim, n.bit_length() - 1, (j(A[:nP]), j(B[:nP]), j([Cp])[0]),
        (j(A[nP:]), j(B[nP:]), j(Cs)), coeffs, tr)
    return ([p.coeffs_except_linear_term for p in proof.compressed_polys], r,
            _claims(cp, cd), _sponge(tr))


def _host_reference(n, nP, nS, label):
    """The rounds replayed on the hostpath integer functions with the host
    Transcript (sumcheck.rs:165-330), as ``_jax_reference`` returns them."""
    from spartan_tpu_torch.core.unipoly import UniPoly

    A, B, Cp, Cs, claim, coeffs = _instance(n, nP, nS)
    HA, HB = [F.decode_fr(p.Z) for p in A], [F.decode_fr(p.Z) for p in B]
    HCp, HCs = F.decode_fr(Cp.Z), [F.decode_fr(p.Z) for p in Cs]
    tr = Transcript(label)
    e, polys, r = claim % P, [], []
    for _ in range(n.bit_length() - 1):
        ev = [HP.cubic_prod_evals(HA[k], HB[k], HCp if k < nP else HCs[k - nP])
              for k in range(nP + nS)]
        c0, c2, c3 = (sum(v[i] * c for v, c in zip(ev, coeffs)) % P for i in range(3))
        poly = UniPoly.from_evals([c0, (e - c0) % P, c2, c3])
        poly.append_to_transcript(b"poly", tr)
        r_j = tr.challenge_scalar(b"challenge_nextround")
        HA, HB, HCs = ([HP.fold_top(t, r_j) for t in T] for T in (HA, HB, HCs))
        HCp = HP.fold_top(HCp, r_j)
        polys.append(poly.compress().coeffs_except_linear_term)
        r.append(r_j)
        e = poly.evaluate(r_j)
    claims = ([t[0] for t in HA[:nP]], [t[0] for t in HB[:nP]], HCp[0]), \
        ([t[0] for t in HA[nP:]], [t[0] for t in HB[nP:]], [t[0] for t in HCs])
    return polys, r, _claims(*claims), _sponge(tr)


@pytest.mark.parametrize("n,nP,nS,small,label", [
    (64, 3, 0, None, b"fused equiv"), (32, 2, 2, None, b"fused equiv"),
    (128, 12, 6, None, b"fused equiv"),
    # the above-tail chain (S2 -> T1 -> S1/S2) at the leaf layout
    (128, 12, 6, 16, b"fused equiv"),
    (64, 3, 0, None, b"vs jax"),
    # up to SMALL_BUCKET_N (2^14): the whole sumcheck in one T2
    (8192, 1, 0, None, b"fused equiv"), (16384, 1, 1, None, b"fused equiv"),
], ids=["64-3-0-None", "32-2-2-None", "128-12-6-None", "128-12-6-16", "vs-jax",
        "8192-1-0-None", "16384-1-1-None"])
def test_fused_sumcheck_bit_identical(monkeypatch, n, nP, nS, small, label):
    """The fused driver gives spartan_tpu's prove_cubic_batched's round
    polynomials, challenges, claims and final sponge on the same tables; at
    2^13 and 2^14 entries, where spartan_tpu's run is slow, the host replay
    of its rounds stands in for it."""
    if small is not None:
        monkeypatch.setattr(SF, "SMALL_BUCKET_N", small)
    (proof, r, cp, cd), tr = _prove(n, nP, nS, label)
    ref = _host_reference if n >= 1 << 13 else _jax_reference
    polys, r_ref, claims, sponge = ref(n, nP, nS, label)
    assert [q.coeffs_except_linear_term for q in proof.compressed_polys] == polys
    assert r == r_ref
    assert _claims(cp, cd) == claims
    assert _sponge(tr) == sponge


def test_diverging_device_sponge_raises(monkeypatch):
    real = TD.pack_sponge

    def corrupted(transcript, device):
        s = real(transcript, device)
        s[3] ^= 1
        return s

    monkeypatch.setattr(TD, "pack_sponge", corrupted)
    with pytest.raises(RuntimeError, match="diverged from host at round 0"):
        _prove(32, 2, 2)


def test_host_threshold_does_not_change_fused_rounds(monkeypatch):
    """HOST_N decides nothing for the batched product sumcheck without a
    mesh (every round goes to the fused driver)."""
    monkeypatch.setattr(HP, "HOST_N", 2)
    (p1, r1, cp1, _), _ = _prove(64, 2, 1)
    monkeypatch.setattr(HP, "HOST_N", 2048)
    (p2, r2, cp2, _), _ = _prove(64, 2, 1)
    assert r1 == r2 and cp1 == cp2


def test_tail_cluster_every_size():
    """T2's cluster size for every table size from 2 to 2^14 entries: one
    block below TAIL_CLUSTER_N entries, TAIL_MAX_CLUSTER (16) from there, a
    size the launch takes (a power of two, at most n / 2 blocks unless 1),
    so T2 spans 16 SMs at SMALL_BUCKET_N and at 2^12 entries."""
    for k in range(1, 15):
        n = 1 << k
        nb = SK.tail_cluster(n)
        assert nb == (SK.TAIL_MAX_CLUSTER if n >= SK.TAIL_CLUSTER_N else 1), n
        assert nb & (nb - 1) == 0 and (nb == 1 or 2 * nb <= n), n
    assert SK.TAIL_MAX_CLUSTER == 16
    assert SK.tail_cluster(1 << 12) == SK.tail_cluster(SF.SMALL_BUCKET_N) == 16


# ---------------------------------------------------------------------------
# T1 and T2 against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tables(seed, k, n, device):
    rng = np.random.default_rng(seed)
    vals = [int(v) % P for v in rng.integers(1, 1 << 62, size=k * n)]
    return list(F.encode_fr(vals, device=device).reshape(k, n, 8).unbind(0))


@pytest.mark.gpu
def test_t1_chain_matches_plain(cuda):
    """30 rounds of T1 on one sponge against the plain step: every r and
    coefficient, the claim and the final packed sponge."""
    I = 18
    t = Transcript(b"t1")
    sponges = [TD.pack_sponge(t, cuda) for _ in range(2)]
    claims = [F.encode_fr([77], device=cuda)[0].clone() for _ in range(2)]
    coeffs = _tables(1, 1, I, cuda)[0].contiguous()
    outs = [(torch.zeros((30, 4, 8), dtype=torch.int32, device=cuda),
             torch.zeros((30, 8), dtype=torch.int32, device=cuda)) for _ in range(2)]
    before = K.counts()["sc_transcript"]
    for j in range(30):
        ev = _tables(10 + j, 1, 3 * I, cuda)[0].contiguous()
        TD.round_transcript(ev, coeffs, claims[0], sponges[0], outs[0][0][j], outs[0][1][j])
        TD.round_transcript_plain(ev, coeffs, claims[1], sponges[1], outs[1][0][j],
                                  outs[1][1][j])
    assert K.counts()["sc_transcript"] == before + 30
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(claims[0], claims[1]) and torch.equal(sponges[0], sponges[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,nP,nS,cluster", [
    (2, 1, 0, None), (64, 3, 2, None), (1 << 12, 12, 6, None),
    # the prove's other layouts at 2^12: a layer above the leaf, the mem trees
    (1 << 12, 12, 0, None), (1 << 12, 4, 0, None),
    # every cluster size at the leaf layout; a cluster that hands over to
    # one block after its first round; the whole 2^14 sumcheck
    (1 << 12, 12, 6, 1), (1 << 12, 12, 6, 2), (1 << 12, 12, 6, 4), (1 << 12, 12, 6, 8),
    (8, 3, 1, 4), (1 << 14, 12, 6, None)])
def test_t2_matches_plain(cuda, monkeypatch, n, nP, nS, cluster):
    if cluster is not None:
        monkeypatch.setattr(SK, "tail_cluster", lambda n: cluster)
    I = nP + nS
    A, B = _tables(2, I, n, cuda), _tables(3, I, n, cuda)
    Cp, Cs = _tables(4, 1, n, cuda)[0], _tables(5, nS, n, cuda)
    coeffs = _tables(6, 1, I, cuda)[0].contiguous()
    R = n.bit_length() - 1
    t = Transcript(b"t2")
    got = []
    for fn in (SK.prod_tail, SK.prod_tail_plain):
        sponge = TD.pack_sponge(t, cuda)
        claim = F.encode_fr([5], device=cuda)[0].clone()
        polys = torch.zeros((R, 4, 8), dtype=torch.int32, device=cuda)
        rs = torch.zeros((R, 8), dtype=torch.int32, device=cuda)
        finals = fn(A, B, Cp, Cs, coeffs, claim, sponge, polys, rs)
        got.append((finals, polys, rs, claim, sponge))
    for a, b in zip(*got):
        assert torch.equal(a, b)
