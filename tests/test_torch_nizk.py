"""The port's NIZK (the slice end to end) against the JAX package.

(a) the frozen NIZK vector of tests/test_reference_vectors.py;
(b) at 2^6, with the port's host-path thresholds lowered so sumchecks,
    commits, MSMs and bullet rounds run its device-path code (the kernels'
    plain versions on the CPU), the proof bytes equal spartan_tpu's;
(c) each package's verifier accepts the other's proof, from bytes;
(d) a corrupted proof is rejected;
(e) importing the port pulls in neither JAX nor spartan_tpu, and its entry
    points want CUDA unless told device="cpu".
"""

import hashlib
import os
import subprocess
import sys

import pytest

from spartan_tpu_torch import interop
from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.io.keyless_bench import synthetic
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import msm as M
from spartan_tpu_torch.snark import NIZK, Assignment, Instance, NIZKGens
from spartan_tpu_torch.utils.errors import SpartanError
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.serialization import deserialize, serialize
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

LABEL = b"torch_nizk"
TAPE_SEED = bytes([7]) * 32


def test_frozen_nizk_vector():
    inst, vars_, inputs, _ = synthetic(4, seed=11)
    n = inst.inst.num_cons
    gens = NIZKGens(n, n, 1, device="cpu")
    pt = Transcript(b"golden_nizk")
    proof = NIZK.prove(inst, vars_, inputs, gens, pt,
                       RandomTape(b"nizk_proof", seed=bytes([42]) * 32))
    raw = serialize(proof)
    assert len(raw) == 4128
    assert hashlib.sha256(raw).hexdigest() == \
        "56a023e419d1c3c7e0b105c9c2a45dc193a4dc12c790904e122b600dfb5a7a43"
    assert pt.challenge_bytes(b"final", 16).hex() == "454facfbe1d6d7bf9156b00071b08326"
    proof.verify(inst, inputs, Transcript(b"golden_nizk"), gens)


@pytest.fixture(scope="module")
def proofs():
    """One 2^6 instance proved by both packages (port on its device path)."""
    from spartan_tpu import snark as JS
    from spartan_tpu.io.keyless_bench import synthetic as jax_synthetic
    from spartan_tpu.utils.random_tape import RandomTape as JRandomTape
    from spartan_tpu.utils.transcript import Transcript as JTranscript

    jinst, jvars, jinputs, _ = jax_synthetic(6, seed=3)
    js = jinst.inst
    # the port's instance is built from the JAX shape's entries
    shape = interop.r1cs_shape(
        js.num_cons, js.num_vars, js.num_inputs,
        *[(m.rows, m.cols, m.vals) for m in (js.A, js.B, js.C)])
    inst = Instance.from_shape(shape)
    n = js.num_cons
    saved = (HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, HP.HOST_BULLET_N, M.LADDER_N,
             F._HOST_CONVERT_N)
    HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, HP.HOST_BULLET_N, M.LADDER_N, \
        F._HOST_CONVERT_N = 2, 4, 0, 2, 4, 0
    try:
        gens = NIZKGens(n, n, 1, device="cpu")
        proof = NIZK.prove(inst, _assignment(jvars), _assignment(jinputs), gens,
                           Transcript(LABEL), RandomTape(b"nizk_proof", seed=TAPE_SEED))
    finally:
        HP.HOST_N, HP.HOST_MSM_N, HP.HOST_COMMIT_POINTS, HP.HOST_BULLET_N, M.LADDER_N, \
            F._HOST_CONVERT_N = saved
    jgens = JS.NIZKGens(n, n, 1)
    jproof = JS.NIZK.prove(jinst, jvars, jinputs, jgens, JTranscript(LABEL),
                           JRandomTape(b"nizk_proof", seed=TAPE_SEED))
    return {"inst": inst, "inputs": _assignment(jinputs), "gens": gens, "proof": proof,
            "jinst": jinst, "jinputs": jinputs, "jgens": jgens, "jproof": jproof}


def _assignment(a):
    return Assignment(list(a.assignment))


def test_instance_and_digest_match(proofs):
    inst, _, _, _ = synthetic(6, seed=3)
    assert inst.digest == proofs["jinst"].digest == proofs["inst"].digest


def test_device_path_proof_bytes_match_jax(proofs):
    from spartan_tpu.utils.serialization import serialize as jax_serialize

    assert serialize(proofs["proof"]) == jax_serialize(proofs["jproof"])


def test_jax_verifier_accepts_port_proof(proofs):
    from spartan_tpu import snark as JS
    from spartan_tpu.utils.serialization import deserialize as jax_deserialize
    from spartan_tpu.utils.transcript import Transcript as JTranscript

    jp = jax_deserialize(JS.NIZK, serialize(proofs["proof"]))
    jp.verify(proofs["jinst"], proofs["jinputs"], JTranscript(LABEL), proofs["jgens"])


def test_port_verifier_accepts_jax_proof(proofs):
    from spartan_tpu.utils.serialization import serialize as jax_serialize

    p = deserialize(NIZK, jax_serialize(proofs["jproof"]))
    p.verify(proofs["inst"], proofs["inputs"], Transcript(LABEL), proofs["gens"])


@pytest.mark.parametrize("where", ["claimed_ry", "inputs"])
def test_corrupted_proof_rejected(proofs, where):
    p = deserialize(NIZK, serialize(proofs["proof"]))
    inputs = proofs["inputs"]
    if where == "claimed_ry":
        p.r = (list(p.r[0]), [(p.r[1][0] + 1) % F.FR.modulus] + p.r[1][1:])
    else:
        inputs = Assignment([(inputs.assignment[0] + 1) % F.FR.modulus])
    with pytest.raises((SpartanError, AssertionError)):
        p.verify(proofs["inst"], inputs, Transcript(LABEL), proofs["gens"])


def test_import_is_jax_free_and_wants_cuda():
    code = (
        "import sys, torch\n"
        "import spartan_tpu_torch\n"
        "import spartan_tpu_torch.snark, spartan_tpu_torch.interop\n"
        "import spartan_tpu_torch.io.keyless_bench, spartan_tpu_torch.ops.kernels\n"
        "import spartan_tpu_torch.parallel, spartan_tpu_torch.parallel.launch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'spartan_tpu' or m.startswith('spartan_tpu.')]\n"
        "assert not bad, bad\n"
        "from spartan_tpu_torch.snark import NIZKGens\n"
        "if torch.cuda.is_available():\n"
        "    print('cuda present')\n"
        "else:\n"
        "    try:\n"
        "        NIZKGens(4, 4, 1)\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "        print('raised')\n"
        "    else:\n"
        "        raise AssertionError('NIZKGens without device= ran without CUDA')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() in ("raised", "cuda present")


def test_hyrax_commit_and_tables_via_interop(monkeypatch):
    """Generators and dense tables carried over from the JAX package equal
    the port's own and give the same Hyrax row commitments and MLE value,
    with the port's commit on its device path (batched MSM, plain kernels)."""
    import numpy as np
    import torch

    from spartan_tpu.core.mle import DensePolynomial as JDense
    from spartan_tpu.pcs.hyrax import PolyCommitmentGens as JPCGens
    from spartan_tpu.pcs.hyrax import commit_poly as jax_commit_poly
    from spartan_tpu_torch import device as DEV
    from spartan_tpu_torch.pcs.hyrax import PolyCommitmentGens, commit_poly

    jgens = JPCGens(6, b"interop_gens")
    jg = jgens.gens.gens_n
    carried = interop.multicommit_gens(tuple(np.asarray(a) for a in jg.G),
                                       tuple(np.asarray(a) for a in jg.h))
    with DEV.use("cpu"):
        gens = PolyCommitmentGens(6, b"interop_gens")
    own = gens.gens.gens_n
    for a, b in zip(own.G + own.h, carried.G + carried.h):
        assert torch.equal(a, b)
    gens.gens.gens_n = carried

    rng = np.random.default_rng(23)
    vals = [int(v) % F.FR.modulus for v in rng.integers(0, 1 << 62, size=64)]
    jpoly = JDense.from_ints(vals)
    poly = interop.dense_poly(np.asarray(jpoly.Z))
    monkeypatch.setattr(HP, "HOST_COMMIT_POINTS", 0)
    monkeypatch.setattr(HP, "HOST_MSM_N", 4)
    monkeypatch.setattr(M, "LADDER_N", 4)
    comm, _ = commit_poly(poly, gens)
    jcomm, _ = jax_commit_poly(jpoly, jgens)
    assert [c.p for c in comm.C] == [c.p for c in jcomm.C]
    monkeypatch.setattr(HP, "HOST_N", 2)
    r = [int(v) for v in rng.integers(0, 1 << 62, size=6)]
    assert poly.evaluate(r) == jpoly.evaluate(r)


def _host_tables(k, n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[int(v) % F.FR.modulus for v in rng.integers(0, 1 << 62, size=n)]
            for _ in range(k)]


@pytest.mark.parametrize("kind", ["cubic_prod", "cubic_additive", "quad"])
def test_sumcheck_round_helpers_vs_host(kind):
    """The round evals and folds of the sumcheck round kernels (their
    plain versions here) equal the host bigint ones."""
    from spartan_tpu_torch.ops import sumcheck_kernels as SK

    k = {"cubic_prod": 3, "cubic_additive": 4, "quad": 2}[kind]
    host = _host_tables(k, 16, 30 + k)
    dev = [F.encode_fr(t, device="cpu") for t in host]
    if kind == "cubic_prod":
        got = F.decode_fr(SK.prod_evals(*[[t] for t in dev]))
        want = list(HP.cubic_prod_evals(*host))
    elif kind == "cubic_additive":
        got = F.decode_fr(SK.additive_evals(*dev))
        want = list(HP.cubic_additive_evals(*host))
        *folded, ev = SK.additive_step(*dev, F.encode_fr([12345], device="cpu")[0])
        assert F.decode_fr(ev) == list(HP.cubic_additive_evals(
            *[HP.fold_top(t, 12345) for t in host]))
        assert [F.decode_fr(t) for t in folded] == [HP.fold_top(t, 12345) for t in host]
    else:
        got = F.decode_fr(SK.quad_evals(*dev))
        want = list(HP.quad_evals(*host))
    assert got == want


def test_instance_new_and_is_sat():
    """Instance.new's column remap and digest match the JAX package; is_sat
    runs the SpMV on the device path."""
    A = [(0, 0, 1)]
    B = [(0, 0, 1)]
    C = [(0, 0, 1)]
    from spartan_tpu import snark as JS

    inst = Instance.new(1, 3, 1, A, B, C)
    jinst = JS.Instance.new(1, 3, 1, A, B, C)
    assert inst.digest == jinst.digest
    assert inst.is_sat(Assignment([1, 0, 0]), Assignment([1]), device="cpu")
    assert not inst.is_sat(Assignment([2, 0, 0]), Assignment([1]), device="cpu")


def test_shape_spmv_and_evaluate_vs_host():
    """A z, A^T e and A(rx, ry) of the port's R1CS shape against host sums."""
    inst, vars_, inputs, _ = synthetic(5, seed=4)
    shape = inst.inst
    z = shape.build_z(vars_.assignment, inputs.assignment)
    p = F.FR.modulus
    Az, _, _ = shape.multiply_vec(shape.num_cons, len(z), z, device="cpu")
    want = [0] * shape.num_cons
    for r, c, v in zip(shape.A.rows.tolist(), shape.A.cols.tolist(), shape.A.vals):
        want[r] = (want[r] + v * z[c]) % p
    assert Az.to_ints() == want
    e = _host_tables(1, shape.num_cons, 40)[0]
    At, _, _ = shape.compute_eval_table_sparse_device(F.encode_fr(e, device="cpu"), len(z))
    want = [0] * len(z)
    for r, c, v in zip(shape.A.rows.tolist(), shape.A.cols.tolist(), shape.A.vals):
        want[c] = (want[c] + v * e[r]) % p
    assert F.decode_fr(At) == want
    rx, ry = _host_tables(2, 5, 41)[0], _host_tables(1, 6, 42)[0]
    ex, ey = HP.eq_evals(rx), HP.eq_evals(ry)
    want = sum(v * ex[r] * ey[c] for r, c, v in
               zip(shape.A.rows.tolist(), shape.A.cols.tolist(), shape.A.vals)) % p
    assert shape.A.evaluate(rx, ry, device="cpu") == want
    assert shape.evaluate(rx, ry, device="cpu")[0] == want


def test_points_from_scalars_fixed_base_path(monkeypatch):
    """The device fixed-base derivation (large batches) equals the host one."""
    from spartan_tpu_torch.core import commitments as CM
    from spartan_tpu_torch.ops import curve_host as CH

    sc = [s for t in _host_tables(1, 6, 43) for s in t] + [0, F.FR.modulus - 1]
    monkeypatch.setattr(CM, "HOST_FIXED_BASE_N", 2)
    x, y, inf = CM.points_from_scalars(sc, device="cpu")
    got = [None if i else (a, b) for a, b, i in
           zip(F.decode_fq(x), F.decode_fq(y), inf.tolist())]
    assert got == [CH.scalar_mul(s, CH.GEN) for s in sc]
