"""The plain reference against the port on the CPU at a tiny size: it accepts
the port's proofs under both commitments and the NIZK, works out the port's
commitment to A, B, C again row for row, and rejects the control's proofs
(a witness that does not satisfy the instance), altered proofs, and under
KZG a proof whose derefs commitment holds the wrong vector, opened as
committed."""

from __future__ import annotations

import random

import pytest

from perfbench import check, sut
from perfbench.control import break_witness
from perfbench.gen import keyless_circom as KC
from perfbench.gen import spartan_synthetic as SS
from perfbench.reference import bn254 as C
from perfbench.reference import proof as P
from perfbench.reference.spartan import Reject
from perfbench.reference.transcript import Transcript
from perfbench.tests import tiny

TRAFFIC = {"hyrax": {"proof": "snark", "pcs": "hyrax", "reference_sample": 1},
           "kzg": {"proof": "snark", "pcs": "kzg", "srs_seed": 0xDEADBEEF,
                   "reference_sample": 1},
           "nizk": {"proof": "nizk", "reference_sample": 1}}


@pytest.fixture(scope="module", params=["hyrax", "kzg", "nizk"])
def cell(request, tmp_path_factory):
    """(inputs, traffic, prover, one sound proof's bytes)."""
    import torch

    kind = request.param
    if kind == "nizk":
        inputs = SS.build(tiny.SYNTH, 21, None)
    else:
        inputs = KC.build(tiny.KEYLESS, 21, str(tmp_path_factory.mktemp("cache")), 2)
    prover = sut.Prover(inputs, TRAFFIC[kind], torch.device("cpu"))
    raw = prover.proof_bytes(prover.prove(b"\x01" * 32, *prover.assign(inputs["witnesses"][0])))
    return inputs, TRAFFIC[kind], prover, raw


def _public(inputs, j=0):
    return inputs["witnesses"][j][0]


def _judge(inputs, traffic, prover, proofs, j=0):
    ref = check.Reference(inputs, traffic)
    return ref.judge([_public(inputs, j)] * len(proofs), proofs, prover.commitment_bytes(), 5,
                     0)


def test_reference_accepts_the_port(cell):
    inputs, traffic, prover, raw = cell
    checks = _judge(inputs, traffic, prover, [raw])
    assert all(c["value"] == 0 for c in checks.values()), checks


def test_reference_rejects_the_control(cell):
    inputs, traffic, prover, _ = cell
    broken = break_witness(7)(inputs["witnesses"])
    raw = prover.proof_bytes(prover.prove(b"\x02" * 32, *prover.assign(broken[0])))
    assert _judge(inputs, traffic, prover, [raw])["rejected_proofs"]["value"] == 1


def test_reference_holds_each_proof_to_its_own_witness(cell):
    inputs, traffic, prover, raw = cell
    if traffic["proof"] == "nizk":   # the instance has one witness
        assert len(inputs["witnesses"]) == 1
        return
    # proved for witness 0, judged as witness 1's: a stale answer
    assert _judge(inputs, traffic, prover, [raw], j=1)["rejected_proofs"]["value"] == 1
    checks = _judge(inputs, traffic, prover, [raw, raw])
    assert checks["duplicate_proofs"]["value"] == 1


def test_kzg_derefs_committed_wrong_are_rejected(cell, monkeypatch):
    """The port commits and opens a derefs vector with its second half
    zeroed, while the lookup argument's claims stay those of the true one:
    the port's own verifier accepts (its KZG check ties neither to the
    claims), the reference does not."""
    from spartan_tpu_torch.core import sparse_mlpoly_full as SMF
    from spartan_tpu_torch.core.mle import DensePolynomial

    inputs, traffic, prover, raw = cell
    if traffic.get("pcs") != "kzg":
        return
    comb = SMF.Derefs.comb

    def half_zeroed(self):
        Z = comb(self).Z.clone()
        Z[len(Z) // 2:] = 0
        return DensePolynomial(Z)

    monkeypatch.setattr(SMF.Derefs, "comb", half_zeroed)
    vars_, assigned = prover.assign(inputs["witnesses"][0])
    proof = prover.prove(b"\x03" * 32, vars_, assigned)
    prover.verify(proof, assigned)
    bad = prover.proof_bytes(proof)
    monkeypatch.setattr(SMF.Derefs, "comb", comb)
    ref = check.Reference(inputs, traffic)
    with pytest.raises(Reject, match="KZG derefs commitment"):
        ref.verify(bad, _public(inputs))
    ref.verify(raw, _public(inputs))


def test_reference_rejects_altered_proofs(cell):
    inputs, traffic, prover, raw = cell
    rng = random.Random(3)
    ref = check.Reference(inputs, traffic)
    public = _public(inputs)
    for _ in range(4):
        # a scalar of the proof, moved by one where it is stored
        pos = 32 * rng.randrange(len(raw) // 32 - 1)
        bad = bytearray(raw)
        v = (int.from_bytes(bad[pos:pos + 32], "little") + 1) % (1 << 256)
        bad[pos:pos + 32] = v.to_bytes(32, "little")
        with pytest.raises((Reject, ValueError)):
            ref.verify(bytes(bad), public)
    wrong_input = [(public[0] + 1) % C.FR] + public[1:]
    with pytest.raises(Reject):
        ref.verify(raw, wrong_input)


def test_commitment_row_changed_is_counted(cell):
    inputs, traffic, prover, raw = cell
    if traffic["proof"] == "nizk":   # no commitment to A, B, C: nothing to count
        assert "commitment_rows_off" not in _judge(inputs, traffic, prover, [raw])
        return
    ref = check.Reference(inputs, traffic)
    program = P.commitment(prover.commitment_bytes())
    assert ref.commitment().differing_rows(program) == 0
    program["comb_ops"][1] = C.jadd(program["comb_ops"][1], C.to_jac(C.GEN))
    assert ref.commitment().differing_rows(program) == 1


def test_transcript_merlin_vector():
    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")


def test_msm_and_gmul_agree_with_double_and_add():
    rng = random.Random(1)
    pts = [C.to_affine(C.jmul(rng.randrange(1, C.FR), C.to_jac(C.GEN))) for _ in range(40)]
    sc = [rng.randrange(C.FR) for _ in pts]
    want = None
    for s, p in zip(sc, pts):
        want = C.jadd(want, C.jmul(s, C.to_jac(p)))
    assert C.jeq(C.msm(sc, pts), want)
    k = rng.randrange(C.FR)
    assert C.jeq(C.gmul(k), C.jmul(k, C.to_jac(C.GEN)))
    assert C.decompress(C.compress(C.gmul(k))) == C.to_affine(C.gmul(k))
