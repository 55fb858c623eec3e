"""The port's circom ingestion (io/r1cs_reader.py) and its benchmark driver
(io/keyless_bench.py) against the JAX package.

(a) the multiplier2 fixture parses to the same header numbers, matrices,
    padded matrices and witness in both packages;
(b) the C parser's matrices equal the Python parser's;
(c) write_r1cs / write_wtns round-trip, and the JAX package reads what the
    port writes;
(d) malformed bytes raise R1CSParseError;
(e) the skew fixture at log2 = 6 proves and verifies on the CPU with bytes
    equal to spartan_tpu's;
(f) keyless_bench.main runs in-process with --device cpu --json on
    multiplier2 for both PCS modes, and a proof saved by either package's
    driver passes the other's --verify-only.
"""

import json
import os
import sys

import pytest

from spartan_tpu_torch.io import keyless_bench as KB
from spartan_tpu_torch.io import r1cs_reader as RR
from spartan_tpu_torch.snark import SNARK, SNARKGens
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.serialization import serialize
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
R1CS = os.path.join(FIXDIR, "multiplier2.r1cs")
WTNS = os.path.join(FIXDIR, "multiplier2.wtns")
TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
P = RR.FR_MOD


def _skew_bytes():
    sys.path.insert(0, TOOLS)
    try:
        import make_circom_fixture as MF
    finally:
        sys.path.remove(TOOLS)
    return MF.big_bytes(6, seed=3)


def _header(r):
    return (r.num_constraints, r.num_variables, r.num_pub_inputs, r.num_prv_inputs,
            r.num_labels)


def test_multiplier2_matches_jax():
    from spartan_tpu.io import r1cs_reader as JRR

    r, jr = RR.R1CSFile.from_file(R1CS), JRR.R1CSFile.from_file(R1CS)
    assert _header(r) == _header(jr) == (1, 4, 1, 2, 4)
    assert (r.a, r.b, r.c) == (jr.a, jr.b, jr.c) == (
        [(0, 2, P - 1)], [(0, 3, 1)], [(0, 1, P - 1)])
    assert r.num_private_vars() == jr.num_private_vars() == 2
    assert r.to_sparse_matrices_padded(2) == jr.to_sparse_matrices_padded(2)
    assert r.to_sparse_matrices() == jr.to_sparse_matrices()
    assert RR.parse_wtns(WTNS) == JRR.parse_wtns(WTNS) == [1, 33, 3, 11]


@pytest.mark.parametrize("which", ["multiplier2", "skew"])
def test_c_parser_equals_python_parser(which):
    from spartan_tpu_torch import native

    data = open(R1CS, "rb").read() if which == "multiplier2" else _skew_bytes()[0]
    r = RR.R1CSFile.from_bytes(data)
    # the constraints section starts after the magic/version header (12
    # bytes), the header section (12 + its size) and its own 12-byte head
    hsize = int.from_bytes(data[16:24], "little")
    off = 12 + 12 + hsize + 12
    assert int.from_bytes(data[12 + 12 + hsize:12 + 12 + hsize + 4], "little") == 2
    assert native.available
    parsed = native.r1cs_parse_native(data, off, r.num_constraints, 32)
    mats = []
    for rows, cols, raw in parsed:
        vals = [int.from_bytes(raw[32 * i:32 * i + 32].tobytes(), "little")
                for i in range(rows.shape[0])]
        mats.append([(int(a), int(b), v) for a, b, v in zip(rows, cols, vals) if v < P])
    py = RR._parse_constraints_py(data, off, r.num_constraints, 32)
    assert tuple(mats) == tuple(py) == (r.a, r.b, r.c)
    csize = int.from_bytes(data[off - 8:off], "little")
    assert native.r1cs_parse_native(data[:off + csize - 1], off, r.num_constraints, 32) is None


def test_write_roundtrip(tmp_path):
    """One public p, privates w0, w1: w0 * w0 = w1, w1 * 1 = p."""
    from spartan_tpu.io import r1cs_reader as JRR

    cons = [([(2, 1)], [(2, 1)], [(3, 1)]), ([(3, 1)], [(0, 1)], [(1, P - 5)])]
    rp, wp = str(tmp_path / "t.r1cs"), str(tmp_path / "t.wtns")
    RR.write_r1cs(rp, num_variables=4, num_pub=1, num_prv=2, constraints=cons)
    RR.write_wtns(wp, [1, 9, 3, 9])
    r, jr = RR.R1CSFile.from_file(rp), JRR.R1CSFile.from_file(rp)
    assert _header(r) == _header(jr) == (2, 4, 1, 2, 4)
    assert r.a == jr.a == [(0, 2, 1), (1, 3, 1)]
    assert r.c == jr.c == [(0, 3, 1), (1, 1, P - 5)]
    assert RR.parse_wtns(wp) == JRR.parse_wtns(wp) == [1, 9, 3, 9]
    assert open(rp, "rb").read() == _jax_written(tmp_path, cons)


def _jax_written(tmp_path, cons) -> bytes:
    from spartan_tpu.io import r1cs_reader as JRR

    path = str(tmp_path / "jax.r1cs")
    JRR.write_r1cs(path, num_variables=4, num_pub=1, num_prv=2, constraints=cons)
    return open(path, "rb").read()


def _malformed():
    good = open(R1CS, "rb").read()
    hsize = int.from_bytes(good[16:24], "little")
    return {
        "magic": b"r1cx" + good[4:],
        "version": good[:4] + (2).to_bytes(4, "little") + good[8:],
        "no_header": good[:12] + (9).to_bytes(4, "little") + good[16:],
        "truncated_header": good[:40],
        "truncated_constraints": good[:12 + 12 + hsize + 12 + 10],
        "short": b"r1cs",
    }


@pytest.mark.parametrize("case", ["magic", "version", "no_header", "truncated_header",
                                  "truncated_constraints", "short", "wtns_magic",
                                  "wtns_short"])
def test_malformed_bytes_raise(case):
    with pytest.raises(RR.R1CSParseError):
        if case.startswith("wtns"):
            good = open(WTNS, "rb").read()
            RR.parse_wtns(b"wtnx" + good[4:] if case == "wtns_magic" else good[:9])
        else:
            RR.R1CSFile.from_bytes(_malformed()[case])


def test_skew_fixture_proves_like_jax(tmp_path):
    from spartan_tpu import snark as JS
    from spartan_tpu.io.keyless_bench import load_circom as jax_load_circom
    from spartan_tpu.utils.random_tape import RandomTape as JRandomTape
    from spartan_tpu.utils.serialization import serialize as jax_serialize
    from spartan_tpu.utils.transcript import Transcript as JTranscript

    r1cs, wtns, stats = _skew_bytes()
    rp, wp = tmp_path / "skew.r1cs", tmp_path / "skew.wtns"
    rp.write_bytes(r1cs)
    wp.write_bytes(wtns)
    inst, vars_, inputs, nnz = KB.load_circom(str(rp), str(wp))
    jinst, jvars, jinputs, jnnz = jax_load_circom(str(rp), str(wp))
    assert stats["constraints"] == 64 and nnz == jnnz
    assert inst.digest == jinst.digest
    assert inst.is_sat(vars_, inputs, device="cpu")
    shape = inst.inst
    seed = b"\x21" * 32
    gens = SNARKGens(shape.num_cons, shape.num_vars, shape.num_inputs, nnz, device="cpu")
    comm, decomm = SNARK.encode(inst, gens)
    proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(b"skew_test"),
                        RandomTape(b"snark_proof", seed=seed))
    proof.verify(comm, inputs, Transcript(b"skew_test"), gens)
    jgens = JS.SNARKGens(shape.num_cons, shape.num_vars, shape.num_inputs, jnnz)
    jcomm, jdecomm = JS.SNARK.encode(jinst, jgens)
    jproof = JS.SNARK.prove(jinst, jcomm, jdecomm, jvars, jinputs, jgens,
                            JTranscript(b"skew_test"), JRandomTape(b"snark_proof", seed=seed))
    assert serialize(comm) == jax_serialize(jcomm)
    assert serialize(proof) == jax_serialize(jproof)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("pcs", ["hyrax", "kzg"])
def test_keyless_bench_main_on_multiplier2(monkeypatch, tmp_path, capsys, pcs):
    monkeypatch.setenv("SPARTAN_TPU_SRS", str(tmp_path / "srs.npz"))
    KB.main(["--r1cs", R1CS, "--wtns", WTNS, "--device", "cpu", "--json", "--pcs", pcs,
             "--save", str(tmp_path / "saved")])
    report = _last_json(capsys.readouterr().out)
    assert report["verified"] and report["pcs"] == pcs and report["backend"] == "cpu"
    assert report["device"] == "cpu" and report["num_cons"] == 2 and report["nnz"] == [1, 1, 1]
    for key in ("gens_s", "encode_s", "prove_s", "verify_s", "proof_bytes", "proof_sha256",
                "prove_phases", "encode_phases", "verify_phases", "prove_acc"):
        assert key in report
    if pcs == "kzg":
        assert os.path.exists(tmp_path / "srs.npz")
    KB.main(["--r1cs", R1CS, "--wtns", WTNS, "--device", "cpu", "--json", "--pcs", pcs,
             "--verify-only", str(tmp_path / "saved")])
    assert _last_json(capsys.readouterr().out)["verified"]


def test_saved_proofs_cross_verify(tmp_path, capsys, monkeypatch):
    """--save of one package's driver, --verify-only of the other's, both
    ways, on multiplier2 (KZG proofs cross-verify in test_torch_snark.py)."""
    from spartan_tpu.io import keyless_bench as JKB

    args = ["--r1cs", R1CS, "--wtns", WTNS, "--json"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["keyless_bench"] + args + ["--save", jdir])
    JKB.main()
    KB.main(args + ["--device", "cpu", "--verify-only", jdir])
    assert _last_json(capsys.readouterr().out)["verified"]
    KB.main(args + ["--device", "cpu", "--save", pdir])
    monkeypatch.setattr(sys, "argv", ["keyless_bench"] + args + ["--verify-only", pdir])
    JKB.main()
    assert _last_json(capsys.readouterr().out)["verified"]


def test_profile_config_prints_phases(monkeypatch, capsys):
    """SpartanConfig.profile defaults from SPARTAN_TPU_PROFILE == "1", as
    in spartan_tpu, and makes keyless_bench.run turn on the Timer's
    printing of each phase (spartan_tpu/io/keyless_bench.py:130-133)."""
    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.utils.timer import Timer

    monkeypatch.setenv("SPARTAN_TPU_PROFILE", "1")
    assert SpartanConfig().profile
    monkeypatch.setenv("SPARTAN_TPU_PROFILE", "0")
    assert not SpartanConfig().profile
    monkeypatch.setattr(Timer, "_enabled", False)
    KB.run(*KB.load_circom(R1CS, WTNS), config=SpartanConfig(pcs="hyrax", profile=True),
           device="cpu", tape_seed=bytes([1]) * 32)
    assert Timer._enabled
    out = capsys.readouterr().out
    assert "* R1CSProof::prove" in out
