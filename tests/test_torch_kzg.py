"""The port's KZG commitments (pcs/kzg.py) against the host oracles and
the JAX package.

(a) the seeded SRS: the same affine points and [tau]G2 as spartan_tpu's,
    with its powers on the host and, with the fixed-base threshold
    lowered, on the device-path code (the product scan and the fixed-base
    table, their plain versions on the CPU);
(b) commit, open, a random polynomial, the z = 0 opening and the batched
    opening: values and points equal the host curve's (curve_host MSMs of
    a host synthetic division) and spartan_tpu's commitment and quotient
    points; the pairing checks accept them and reject a wrong evaluation;
(c) the quotient scan equals host synthetic division at 1, 2, 17 and 64
    coefficients;
(d) an SRS file saved by either package loads in the other with equal
    points, and load_or_generate reuses a large enough file.
"""

import random

import numpy as np
import pytest

from spartan_tpu_torch.core import commitments as CM
from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.ops import curve_host as CH
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops.limbs import limbs16_to_32
from spartan_tpu_torch.pcs import kzg as PK
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

P = F.FR.modulus
SEED = 12345


@pytest.fixture(scope="module")
def srs():
    return PK.KZGSrs.setup_from_seed(32, SEED, device="cpu")


@pytest.fixture(scope="module")
def jsrs():
    from spartan_tpu.pcs.kzg import KZGSrs

    return KZGSrs.setup_from_seed(32, SEED)


def _coeffs(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def _same_points(jpoints, ppoints):
    jx, jy, jinf = (np.asarray(a) for a in jpoints)
    return (np.array_equal(limbs16_to_32(jx), ppoints[0].numpy())
            and np.array_equal(limbs16_to_32(jy), ppoints[1].numpy())
            and np.array_equal(jinf, ppoints[2].numpy()))


def _host_quotient(cs, z):
    """Synthetic division of p(x) - p(z) by (x - z), highest term first
    (kzg.rs:231-256): q has len(cs) - 1 coefficients."""
    q = [0] * (len(cs) - 1)
    acc = 0
    for i in range(len(cs) - 1, 0, -1):
        acc = (acc * z + cs[i]) % P
        q[i - 1] = acc
    return q


def _host_eval(cs, z):
    acc = 0
    for c in reversed(cs):
        acc = (acc * z + c) % P
    return acc


@pytest.mark.parametrize("host_fixed_base_n", [4096, 2])
def test_srs_matches_jax(monkeypatch, jsrs, host_fixed_base_n):
    """At 2 the points come from the fixed-base table on tensors, in
    gather passes of 8 scalars: 33 points cross four chunk boundaries."""
    monkeypatch.setattr(CM, "HOST_FIXED_BASE_N", host_fixed_base_n)
    monkeypatch.setattr(CM, "FIXED_BASE_CHUNK", 8)
    ours = PK.KZGSrs.setup_from_seed(32, SEED, device="cpu")
    assert ours.size == jsrs.size == 33
    assert _same_points(jsrs.powers_g1, ours.powers_g1)
    assert ours.tau_g2 == jsrs.tau_g2 and ours.g2 == jsrs.g2


def test_commit_open(srs, jsrs):
    """p(x) = 1 + 2x + 3x^2: p(5) = 86 (tests/test_kzg.py's case)."""
    from spartan_tpu.ops import field_jax as JF
    from spartan_tpu.pcs import kzg as JK

    coeffs = F.encode_fr([1, 2, 3], device="cpu")
    comm = PK.KZGCommitment.commit(coeffs, srs)
    proof, ev = PK.KZGProof.prove(coeffs, 5, srs)
    assert ev == 86
    pts = srs.host_points(3)
    assert comm.commitment.p == CH.msm([1, 2, 3], pts)
    assert proof.proof.p == CH.msm(_host_quotient([1, 2, 3], 5), pts[:2])
    jc = JF.encode_fr([1, 2, 3])
    jproof, jev = JK.KZGProof.prove(jc, 5, jsrs)
    assert JK.KZGCommitment.commit(jc, jsrs).commitment.p == comm.commitment.p
    assert (jproof.proof.p, jev) == (proof.proof.p, ev)
    assert proof.verify(comm, 5, 86, srs)
    assert not proof.verify(comm, 5, 100, srs)


@pytest.mark.parametrize("host_commit_points", [16384, 0])
def test_random_poly(monkeypatch, srs, jsrs, host_commit_points):
    """16 random coefficients at a random point; with the threshold at 0
    both MSMs run the device-path MSM (plain versions on the CPU)."""
    from spartan_tpu.ops import field_jax as JF
    from spartan_tpu.pcs import kzg as JK

    monkeypatch.setattr(HP, "HOST_COMMIT_POINTS", host_commit_points)
    cs = _coeffs(1, 16)
    z = _coeffs(2, 1)[0]
    coeffs = F.encode_fr(cs, device="cpu")
    comm = PK.KZGCommitment.commit(coeffs, srs)
    proof, ev = PK.KZGProof.prove(coeffs, z, srs)
    assert ev == _host_eval(cs, z)
    pts = srs.host_points(16)
    assert comm.commitment.p == CH.msm(cs, pts)
    assert proof.proof.p == CH.msm(_host_quotient(cs, z), pts[:15])
    jc = JF.encode_fr(cs)
    jproof, jev = JK.KZGProof.prove(jc, z, jsrs)
    assert JK.KZGCommitment.commit(jc, jsrs).commitment.p == comm.commitment.p
    assert (jproof.proof.p, jev) == (proof.proof.p, ev)
    if host_commit_points:
        assert proof.verify(comm, z, ev, srs)


def test_zero_point_opening(srs, jsrs):
    """At z = 0 the quotient is the coefficient shift."""
    from spartan_tpu.ops import field_jax as JF
    from spartan_tpu.pcs import kzg as JK

    cs = _coeffs(3, 9)
    coeffs = F.encode_fr(cs, device="cpu")
    comm = PK.KZGCommitment.commit(coeffs, srs)
    proof, ev = PK.KZGProof.prove(coeffs, 0, srs)
    assert ev == cs[0]
    assert proof.proof.p == CH.msm(cs[1:], srs.host_points(8))
    jproof, jev = JK.KZGProof.prove(JF.encode_fr(cs), 0, jsrs)
    assert (jproof.proof.p, jev) == (proof.proof.p, ev)
    assert proof.verify(comm, 0, ev, srs)


def test_batched(srs, jsrs):
    """The gamma-RLC batch opening of three polynomials equals the JAX
    one; it verifies, and a tampered evaluation fails."""
    from spartan_tpu.ops import field_jax as JF
    from spartan_tpu.pcs import kzg as JK
    from spartan_tpu.utils.transcript import Transcript as JTranscript

    polys = [_coeffs(10 + i, 8) for i in range(3)]
    z = _coeffs(4, 1)[0]
    gens = PK.KZGPolyCommitmentGens(srs)
    ptens = [F.encode_fr(p, device="cpu") for p in polys]
    comm = PK.KZGBatchedCommitment.commit(ptens, gens)
    proof = PK.KZGBatchedEvalProof.prove(ptens, z, gens, Transcript(b"kzg_batch"))
    assert proof.evals == [_host_eval(p, z) for p in polys]
    jgens = JK.KZGPolyCommitmentGens(jsrs)
    jpolys = [JF.encode_fr(p) for p in polys]
    jcomm = JK.KZGBatchedCommitment.commit(jpolys, jgens)
    jproof = JK.KZGBatchedEvalProof.prove(jpolys, z, jgens, JTranscript(b"kzg_batch"))
    assert [c.p for c in jcomm.commitments] == [c.p for c in comm.commitments]
    assert (jproof.proof.p, jproof.evals) == (proof.proof.p, proof.evals)
    assert proof.verify(comm, z, gens, Transcript(b"kzg_batch"))
    proof.evals[0] = (proof.evals[0] + 1) % P
    assert not proof.verify(comm, z, gens, Transcript(b"kzg_batch"))


@pytest.mark.parametrize("n", [1, 2, 17, 64])
def test_quotient_scan_vs_synthetic_division(n):
    cs = _coeffs(20 + n, n)
    z = _coeffs(30 + n, 1)[0]
    coeffs = F.encode_fr(cs, device="cpu")
    zpow = PK.k_powers(F.encode_fr([z], device="cpu")[0], n)
    assert F.decode_fr(zpow) == [pow(z, i, P) for i in range(n)]
    q = PK.k_quotient(coeffs, zpow, F.encode_fr([pow(z, -1, P)], device="cpu")[0])
    assert tuple(q.shape) == (n - 1, 8)
    assert F.decode_fr(q) == _host_quotient(cs, z)
    suffix = F.fr.scan_add(coeffs, reverse=True)
    assert F.decode_fr(suffix) == [sum(cs[i:]) % P for i in range(n)]


def test_srs_file_loads_in_both_packages(srs, jsrs, tmp_path):
    from spartan_tpu.pcs.kzg import KZGSrs as JKZGSrs

    ours = str(tmp_path / "port_srs.npz")
    srs.save_to_file(ours)
    theirs = JKZGSrs.load_from_file(ours)
    assert theirs.size == srs.size and theirs.tau_g2 == srs.tau_g2 and theirs.g2 == srs.g2
    assert _same_points(theirs.powers_g1, srs.powers_g1)

    jpath = str(tmp_path / "jax_srs")
    jsrs.save_to_file(jpath)
    loaded = PK.KZGSrs.load_from_file(jpath, device="cpu")
    assert loaded.size == jsrs.size and loaded.tau_g2 == jsrs.tau_g2
    assert _same_points(jsrs.powers_g1, loaded.powers_g1)
    # a file of enough points is reused whatever its seed; a short one is
    # replaced by a new SRS of the given seed
    reused = PK.KZGSrs.load_or_generate(jpath, 20, 99, device="cpu")
    assert reused.tau_g2 == jsrs.tau_g2
    grown = PK.KZGSrs.load_or_generate(ours, 40, SEED, device="cpu")
    assert grown.size == 41 and grown.tau_g2 == srs.tau_g2
    assert PK.KZGSrs.load_from_file(ours, device="cpu").size == 41
