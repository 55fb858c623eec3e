"""The port's SNARK (the slice end to end) against the JAX package.

At the size of ``tests/test_snark_e2e.py``'s instance (8 constraints, 8
variables, one input), with the same label and seeded RandomTape, for each
derefs commitment (``pcs`` hyrax and kzg, the KZG SRS of the default seed
loaded or generated at a path of the test's own):
(a) the commitment and the serialized proof are byte-identical to
    spartan_tpu's, with the port's sumchecks on their device-path code
    (the kernels' plain versions on the CPU; host tail lowered to 2);
(b) each package's verifier accepts the other's proof, from bytes;
(c) corrupted proofs are rejected as tests/test_snark_e2e.py:76 expects;
(d) the proof and commitment survive a serialization round trip in their
    mode, and do not parse in the other.
Also the pieces the SNARK adds: the dense representation and its
timestamps, the product-tree proofs and the MLE helpers.
"""

import numpy as np
import pytest
import torch

from spartan_tpu_torch import interop
from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core import mle
from spartan_tpu_torch.core import sumcheck_fused as SF
from spartan_tpu_torch.core.mle import DensePolynomial, IdentityPolynomial
from spartan_tpu_torch.config import SpartanConfig
from spartan_tpu_torch.core.product_tree import (
    DotProductCircuit,
    ProductCircuit,
    ProductCircuitEvalProof,
    ProductCircuitEvalProofBatched,
)
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.core.r1cs import R1CSCommitment
from spartan_tpu_torch.snark import SNARK, Assignment, Instance, SNARKGens
from spartan_tpu_torch.utils.errors import SpartanError
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.serialization import deserialize, serialize
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

LABEL = b"torch_snark"
TAPE_SEED = bytes([6]) * 32
P = F.FR.modulus


def _assignment(a):
    return Assignment(list(a.assignment))


@pytest.fixture(scope="module", params=["hyrax", "kzg"])
def snarks(request, tmp_path_factory):
    """One 8-constraint instance proved by both packages with the derefs
    committed by ``request.param``."""
    from spartan_tpu import snark as JS
    from spartan_tpu.config import SpartanConfig as JSpartanConfig
    from spartan_tpu.io.keyless_bench import synthetic as jax_synthetic
    from spartan_tpu.utils.random_tape import RandomTape as JRandomTape
    from spartan_tpu.utils.transcript import Transcript as JTranscript

    jinst, jvars, jinputs, nnz = jax_synthetic(3, seed=5)
    js = jinst.inst
    shape = interop.r1cs_shape(js.num_cons, js.num_vars, js.num_inputs,
                               *[(m.rows, m.cols, m.vals) for m in (js.A, js.B, js.C)])
    inst = Instance.from_shape(shape)
    n = js.num_cons
    pcs = request.param
    srs_dir = tmp_path_factory.mktemp("srs")
    saved = HP.HOST_N
    HP.HOST_N = 2
    try:
        gens = SNARKGens(n, n, 1, nnz, device="cpu", config=SpartanConfig(
            pcs=pcs, srs_path=str(srs_dir / "port.npz")))
        comm, decomm = SNARK.encode(inst, gens)
        proof = SNARK.prove(inst, comm, decomm, _assignment(jvars), _assignment(jinputs),
                            gens, Transcript(LABEL), RandomTape(b"snark_proof", seed=TAPE_SEED))
    finally:
        HP.HOST_N = saved
    jgens = JS.SNARKGens(n, n, 1, nnz, config=JSpartanConfig(
        pcs=pcs, srs_path=str(srs_dir / "jax.npz")))
    jcomm, jdecomm = JS.SNARK.encode(jinst, jgens)
    jproof = JS.SNARK.prove(jinst, jcomm, jdecomm, jvars, jinputs, jgens, JTranscript(LABEL),
                            JRandomTape(b"snark_proof", seed=TAPE_SEED))
    return {"pcs": pcs, "inst": inst, "vars": _assignment(jvars),
            "inputs": _assignment(jinputs), "gens": gens,
            "comm": comm,
            "decomm": decomm, "proof": proof, "jinst": jinst, "jinputs": jinputs,
            "jgens": jgens, "jcomm": jcomm, "jdecomm": jdecomm, "jproof": jproof}


def test_commitment_bytes_match_jax(snarks):
    from spartan_tpu.utils.serialization import serialize as jax_serialize

    assert serialize(snarks["comm"]) == jax_serialize(snarks["jcomm"])


def test_proof_bytes_match_jax(snarks):
    from spartan_tpu.utils.serialization import serialize as jax_serialize

    assert serialize(snarks["proof"]) == jax_serialize(snarks["jproof"])


def test_second_prove_bytes_match_jax(snarks, monkeypatch):
    """Proved again from the same instance (its matrices' encodings kept
    since the first prove), commitment, gens and tape seed, with every ZK
    round and MLE on its device path (host tail lowered to 2), the proof
    has the first prove's bytes, which are spartan_tpu's."""
    from spartan_tpu.utils.serialization import serialize as jax_serialize

    monkeypatch.setattr(HP, "HOST_N", 2)
    proof = SNARK.prove(snarks["inst"], snarks["comm"], snarks["decomm"], snarks["vars"],
                        snarks["inputs"], snarks["gens"], Transcript(LABEL),
                        RandomTape(b"snark_proof", seed=TAPE_SEED))
    assert serialize(proof) == serialize(snarks["proof"]) == jax_serialize(snarks["jproof"])


def test_cpu_prove_runs_the_fused_driver(snarks, monkeypatch):
    """A CPU prove hands every batched product sumcheck that has rounds to
    the fused driver (T1's and T2's plain versions), the driver the card
    runs, and its proof has the fixture's bytes."""
    from spartan_tpu_torch.core.sumcheck import SumcheckInstanceProof

    calls = {"batched": 0, "fused": 0}
    batched, fused = SumcheckInstanceProof.prove_cubic_batched, SF.prove_cubic_batched_fused

    def counted_batched(claim, num_rounds, *a, **k):
        calls["batched"] += num_rounds > 0
        return batched(claim, num_rounds, *a, **k)

    def counted_fused(*a, **k):
        calls["fused"] += 1
        return fused(*a, **k)

    monkeypatch.setattr(SumcheckInstanceProof, "prove_cubic_batched",
                        staticmethod(counted_batched))
    monkeypatch.setattr(SF, "prove_cubic_batched_fused", counted_fused)
    proof = SNARK.prove(snarks["inst"], snarks["comm"], snarks["decomm"], snarks["vars"],
                        snarks["inputs"], snarks["gens"], Transcript(LABEL),
                        RandomTape(b"snark_proof", seed=TAPE_SEED))
    assert calls["batched"] > 0
    assert calls["fused"] == calls["batched"]
    assert serialize(proof) == serialize(snarks["proof"])


def test_msm_window_proof_bytes_match_jax(snarks, monkeypatch):
    """Proved again with ``SpartanConfig.msm_window`` = 8 in the default
    config, the port's proof has the auto-window proof's bytes, which are
    spartan_tpu's; under Hyrax spartan_tpu proves again with its default
    config's msm_window = 8 too, to the same bytes. (Under KZG its SRS MSM
    would take the bucket path at c = 8, a new XLA compile, so it does
    not.) At this size every MSM of the port, and of spartan_tpu under
    Hyrax, is below its bucket path (the host C MSM or the ladder), so the
    window reaches none of them; tests/test_torch_msm.py's
    test_msm_window_config holds a bucket-path MSM at the fixed window to
    the auto one."""
    from spartan_tpu import config as jconfig
    from spartan_tpu import snark as JS
    from spartan_tpu.utils.random_tape import RandomTape as JRandomTape
    from spartan_tpu.utils.serialization import serialize as jax_serialize
    from spartan_tpu.utils.transcript import Transcript as JTranscript
    from spartan_tpu_torch import config

    monkeypatch.setattr(config.DEFAULT, "msm_window", 8)
    monkeypatch.setattr(jconfig.DEFAULT, "msm_window", 8)
    monkeypatch.setattr(HP, "HOST_N", 2)
    proof = SNARK.prove(snarks["inst"], snarks["comm"], snarks["decomm"], snarks["vars"],
                        snarks["inputs"], snarks["gens"], Transcript(LABEL),
                        RandomTape(b"snark_proof", seed=TAPE_SEED))
    assert serialize(proof) == jax_serialize(snarks["jproof"])
    if snarks["pcs"] == "hyrax":
        jproof = JS.SNARK.prove(snarks["jinst"], snarks["jcomm"], snarks["jdecomm"],
                                JS.Assignment(list(snarks["vars"].assignment)),
                                snarks["jinputs"], snarks["jgens"], JTranscript(LABEL),
                                JRandomTape(b"snark_proof", seed=TAPE_SEED))
        assert jax_serialize(jproof) == serialize(proof)


def test_jax_verifier_accepts_port_proof(snarks):
    from spartan_tpu import snark as JS
    from spartan_tpu.core.r1cs import R1CSCommitment as JComm
    from spartan_tpu.utils.serialization import deserialize as jax_deserialize
    from spartan_tpu.utils.transcript import Transcript as JTranscript

    jp = jax_deserialize(JS.SNARK, serialize(snarks["proof"]), pcs=snarks["pcs"])
    jc = jax_deserialize(JComm, serialize(snarks["comm"]), pcs=snarks["pcs"])
    jp.verify(jc, snarks["jinputs"], JTranscript(LABEL), snarks["jgens"])


def test_port_verifier_accepts_jax_proof(snarks):
    from spartan_tpu.utils.serialization import serialize as jax_serialize

    p = interop.snark_proof(jax_serialize(snarks["jproof"]), pcs=snarks["pcs"])
    c = interop.r1cs_commitment(jax_serialize(snarks["jcomm"]), pcs=snarks["pcs"])
    p.verify(c, snarks["inputs"], Transcript(LABEL), snarks["gens"])


@pytest.mark.parametrize("where", ["inst_evals", "prod_layer_init", "hash_layer_eval_val",
                                   "inputs", "derefs_opening"])
def test_corrupted_proof_rejected(snarks, where):
    p = deserialize(SNARK, serialize(snarks["proof"]), pcs=snarks["pcs"])
    inputs = snarks["inputs"]
    net = p.r1cs_eval_proof.proof.poly_eval_network_proof
    if where == "inst_evals":
        a, b, c = p.inst_evals
        p.inst_evals = ((a + 1) % P, b, c)
    elif where == "prod_layer_init":
        init, read, write, audit = net.proof_prod_layer.eval_row
        net.proof_prod_layer.eval_row = ((init + 1) % P, read, write, audit)
    elif where == "hash_layer_eval_val":
        hl = net.proof_hash_layer
        hl.eval_val = [(hl.eval_val[0] + 1) % P] + hl.eval_val[1:]
    elif where == "derefs_opening":
        # the KZG opening's evaluation, or the Hyrax opening's z1
        opening = net.proof_hash_layer.proof_derefs.proof_derefs
        if snarks["pcs"] == "kzg":
            opening.eval = (opening.eval + 1) % P
        else:
            opening.proof.z1 = (opening.proof.z1 + 1) % P
    else:
        inputs = Assignment([(inputs.assignment[0] + 1) % P])
    with pytest.raises((SpartanError, AssertionError)):
        p.verify(snarks["comm"], inputs, Transcript(LABEL), snarks["gens"])


def test_dense_rep_matches_jax(snarks):
    """Addresses, read/audit timestamps and value tables of the port's
    dense representation equal the JAX one's, and interop carries the JAX
    one across unchanged."""
    d, jd = snarks["decomm"].dense, snarks["jdecomm"].dense
    for side, jside in ((d.row, jd.row), (d.col, jd.col)):
        assert side.num_cells == jside.num_cells and side.num_ops == jside.num_ops
        for a, b in zip(side.ops_addr_usize + side.read_ts_usize,
                        jside.ops_addr_usize + jside.read_ts_usize):
            assert np.array_equal(a, b)
        assert np.array_equal(side.audit_ts_usize, jside.audit_ts_usize)
        assert [p.to_ints() for p in side.read_ts()] == [p.to_ints() for p in jside.read_ts]
    for v, jv in zip(d.val, jd.val):
        assert np.array_equal(interop.from_port(v.Z), np.asarray(jv.Z))
    carried = interop.dense_rep(jd.row.num_cells, jd.row.ops_addr_usize,
                                jd.col.ops_addr_usize, [np.asarray(v.Z) for v in jd.val])
    assert carried.comb_ops().to_ints() == d.comb_ops().to_ints()
    assert carried.comb_mem().to_ints() == d.comb_mem().to_ints()


def test_serialization_roundtrip(snarks):
    """Proof and commitment bytes parse back to the same bytes in their
    mode; the derefs fields make them unreadable in the other mode."""
    pcs = snarks["pcs"]
    other = "hyrax" if pcs == "kzg" else "kzg"
    for cls, obj in ((SNARK, snarks["proof"]), (R1CSCommitment, snarks["comm"])):
        raw = serialize(obj)
        assert serialize(deserialize(cls, raw, pcs=pcs)) == raw
    with pytest.raises((ValueError, TypeError)):
        deserialize(SNARK, serialize(snarks["proof"]), pcs=other)


def test_snark_gens_want_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SNARKGens(8, 8, 1, 24)


def _rand(seed, n):
    rng = np.random.default_rng(seed)
    return [int(v) % P for v in rng.integers(1, 1 << 62, size=n)]


@pytest.mark.parametrize("host_n", [2048, 2])
def test_product_tree_proofs_match_jax(monkeypatch, host_n):
    """Single and batched (with dot-product circuits) layered proofs: the
    port's on its host tail and on its device branch equal the JAX ones
    byte for byte, and verify."""
    from spartan_tpu.core.mle import DensePolynomial as JDP
    from spartan_tpu.core import product_tree as JPT
    from spartan_tpu.utils.serialization import serialize as jax_serialize
    from spartan_tpu.utils.transcript import Transcript as JTranscript

    leaves = [_rand(20 + i, 16) for i in range(3)]
    dots = [_rand(30 + i, 16) for i in range(3)]
    monkeypatch.setattr(HP, "HOST_N", host_n)

    def port(tx):
        c = ProductCircuit(DensePolynomial.from_ints(leaves[0], device="cpu"))
        single = ProductCircuitEvalProof.prove(c, tx)
        circuits = [ProductCircuit(DensePolynomial.from_ints(v, device="cpu"))
                    for v in leaves[1:]]
        d = DotProductCircuit(*[DensePolynomial.from_ints(v, device="cpu") for v in dots])
        batched = ProductCircuitEvalProofBatched.prove(circuits, list(d.split()), tx)
        return single, batched

    def jax(tx):
        c = JPT.ProductCircuit(JDP.from_ints(leaves[0]))
        single = JPT.ProductCircuitEvalProof.prove(c, tx)
        circuits = [JPT.ProductCircuit(JDP.from_ints(v)) for v in leaves[1:]]
        d = JPT.DotProductCircuit(*[JDP.from_ints(v) for v in dots])
        batched = JPT.ProductCircuitEvalProofBatched.prove(circuits, list(d.split()), tx)
        return single, batched

    (sp, claim, rand), (bp, brand) = port(Transcript(b"trees"))
    (jsp, jclaim, jrand), (jbp, jbrand) = jax(JTranscript(b"trees"))
    assert (claim, rand, brand) == (jclaim, jrand, jbrand)
    assert serialize(sp) == jax_serialize(jsp) and serialize(bp) == jax_serialize(jbp)

    prods = [1, 1, 1]
    for k, vals in enumerate(leaves):
        for v in vals:
            prods[k] = prods[k] * v % P
    halves = [sum(a * b % P * c for a, b, c in zip(*[v[h * 8:(h + 1) * 8] for v in dots])) % P
              for h in range(2)]
    vt = Transcript(b"trees")
    assert sp.verify(prods[0], 16, vt)[0] == claim
    bp.verify(prods[1:], halves, 16, vt)


def test_mle_helpers_match_host():
    vals = _rand(40, 8)
    r = _rand(41, 3)
    p = DensePolynomial.from_ints(vals, device="cpu")
    assert DensePolynomial.from_usize(np.array([0, 7, 2 ** 40 + 3]), device="cpu").to_ints() \
        == [0, 7, 2 ** 40 + 3]
    lo, hi = p.split(4)
    assert lo.to_ints() == vals[:4] and hi.to_ints() == vals[4:]
    lo.extend(hi)
    assert lo.to_ints() == vals and lo.num_vars == 3
    m = DensePolynomial.merge([p, DensePolynomial.from_ints(vals[:3], device="cpu")])
    assert m.len == 16 and m.to_ints() == vals + vals[:3] + [0] * 5
    top = p.clone()
    top.bound_poly_var_top(r[0])
    assert top.to_ints() == HP.fold_top(vals, r[0])
    bot = p.clone()
    bot.bound_poly_var_bot(r[0])
    assert bot.to_ints() == [(vals[2 * i] + r[0] * (vals[2 * i + 1] - vals[2 * i])) % P
                             for i in range(4)]
    want = HP.evaluate_mle(vals, r)
    assert mle.batch_evaluate([p, p], r) == [want, want]
    r_dev = F.encode_fr(r, device="cpu")
    assert mle.decode_scalar(p.evaluate_device(r_dev)) == want
    assert IdentityPolynomial(3).evaluate(r) == (4 * r[0] + 2 * r[1] + r[2]) % P
