"""The port's public API against spartan_tpu's.

- every name ``spartan_tpu`` exports resolves in ``spartan_tpu_torch``,
  lazily: importing the port loads neither JAX nor ``spartan_tpu``;
- every public method of every exported class of the JAX package exists
  in the port, its parameters in JAX's order, any extra port parameter
  with a default; the exceptions are the deliberate differences README.md
  lists, held here in ``DIFFERENCES``;
- the sparse matrices' entries form (``SparseMatEntry``, the ``M`` view,
  ``from_arrays``) gives the same shapes and digests as JAX's;
  ``EqPolynomial.evals``, ``compute_eval_table_sparse`` and the
  ``secure=True`` generators equal JAX's;
- README's usage example, with the port's import line, proves the JAX
  package's bytes, and each verifier accepts the other's proof.
"""

import importlib
import inspect
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import spartan_tpu_torch
from spartan_tpu_torch.core import commitments as CM
from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.ops.fields_host import FR_MOD

from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# spartan_tpu's export table (spartan_tpu/__init__.py)
JAX_EXPORTS = [
    "Assignment", "VarsAssignment", "InputsAssignment", "Instance", "NIZK", "NIZKGens",
    "SNARK", "SNARKGens", "R1CSShape", "R1CSGens", "R1CSProof", "DensePolynomial",
    "EqPolynomial", "MultiCommitGens", "GroupElem", "SumcheckInstanceProof",
    "ZKSumcheckInstanceProof", "UniPoly", "CompressedUniPoly", "PolyCommitmentGens",
    "PolyEvalProof", "KZGSrs", "Transcript", "RandomTape", "ProofVerifyError", "R1CSError",
    "Timer", "SpartanConfig", "R1CSFile", "parse_wtns",
]

# The deliberate differences of the port's API, as README.md lists them
# ("Deliberate API differences"): the README's name of each, its reason, and
# the (method, parameter) pairs it excuses in the signature comparison
# ("*": any method).
DIFFERENCES = {
    "device=": ("an extra keyword, last and defaulted: where the work runs, the CUDA card "
                "unless device='cpu'", [("*", "device")]),
    "mesh=": ("takes the port's parallel.Mesh over a torch.distributed group, not a JAX "
              "mesh", []),
    "mesh_devices": ("SpartanConfig field dropped: the mesh is built from the process "
                     "group, make_mesh()",
                     [("SpartanConfig.__init__", "mesh_devices")]),
    "own_seq": ("prove_cubic_batched parameter dropped: the port has one batched "
                "product-sumcheck path for all instances",
                [("SumcheckInstanceProof.prove_cubic_batched", "own_seq")]),
    "tuning variables": ("the JAX package's tuning environment variables are module "
                         "attributes of the port, its cache locations fixed under "
                         "build/", []),
    "internal helpers": ("the JAX package's jitted k_* functions, DeviceTranscript, "
                         "ops/*_jax.py, pallas_* and scan.py have CUDA kernels and their "
                         "wrappers in their place", []),
    "R1CSParseError": ("the port's circom reader raises R1CSParseError on truncated bytes, "
                       "where the JAX reader lets struct.error escape", []),
}
EXCUSED = {pair: key for key, (_, pairs) in DIFFERENCES.items() for pair in pairs}


@pytest.mark.parametrize("name", JAX_EXPORTS)
def test_export_resolves(name):
    import spartan_tpu

    assert name in spartan_tpu_torch.__all__
    port = getattr(spartan_tpu_torch, name)
    jax_obj = getattr(spartan_tpu, name)
    assert port.__name__ == jax_obj.__name__


def test_import_stays_light():
    """Importing the port loads no JAX, no spartan_tpu and no torch; the
    30 names resolve without JAX or spartan_tpu and without touching CUDA."""
    code = (
        "import sys\n"
        "import spartan_tpu_torch as S\n"
        "bad = [m for m in ('jax', 'spartan_tpu', 'torch') if m in sys.modules]\n"
        "assert not bad, bad\n"
        f"names = {JAX_EXPORTS!r}\n"
        "for n in names:\n"
        "    getattr(S, n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'spartan_tpu.'))"
        " or m == 'spartan_tpu']\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _params(fn):
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _public_methods(cls):
    for attr in sorted(dir(cls)):
        if attr.startswith("_") and attr != "__init__":
            continue
        raw = inspect.getattr_static(cls, attr)
        if isinstance(raw, (staticmethod, classmethod)) or inspect.isfunction(raw):
            yield attr, raw


def _signature_faults(label, jax_fn, port_fn) -> list[str]:
    faults = []
    jp = _params(jax_fn)
    pp = {p.name: p for p in _params(port_fn)}
    kept = [p for p in jp if (label, p.name) not in EXCUSED]
    for p in jp:
        if (label, p.name) in EXCUSED and p.name in pp:
            faults.append(f"{label}: {p.name} is excused as dropped but the port has it")
    port_order = [p.name for p in _params(port_fn)]
    if port_order[:len(kept)] != [p.name for p in kept]:
        faults.append(f"{label}: parameters {port_order} do not begin with JAX's "
                      f"{[p.name for p in kept]}")
        return faults
    for p in kept:
        q = pp[p.name]
        if q.kind != p.kind:
            faults.append(f"{label}: {p.name} is {q.kind}, JAX's is {p.kind}")
        if p.default is not p.empty and q.default is q.empty:
            faults.append(f"{label}: {p.name} has no default, JAX's has")
    for name in port_order[len(kept):]:
        q = pp[name]
        if q.default is q.empty:
            faults.append(f"{label}: extra parameter {name} has no default")
        if ("*", name) not in EXCUSED and (label, name) not in EXCUSED:
            faults.append(f"{label}: extra parameter {name} is not a listed difference")
    return faults


SIGNATURE_NAMES = [n for n in JAX_EXPORTS if n not in ("VarsAssignment", "InputsAssignment")]


@pytest.mark.parametrize("name", SIGNATURE_NAMES)
def test_signature_parity(name):
    import spartan_tpu

    jax_obj = getattr(spartan_tpu, name)
    port = getattr(spartan_tpu_torch, name)
    if not inspect.isclass(jax_obj):
        assert _signature_faults(name, jax_obj, port) == []
        return
    faults = []
    for attr, raw in _public_methods(jax_obj):
        label = f"{name}.{attr}"
        if attr not in dir(port):
            faults.append(f"{label} is missing")
            continue
        praw = inspect.getattr_static(port, attr)
        if type(praw) is not type(raw):
            faults.append(f"{label} is a {type(praw).__name__}, JAX's a {type(raw).__name__}")
            continue
        faults += _signature_faults(label, getattr(jax_obj, attr), getattr(port, attr))
    assert faults == []


def test_differences_are_listed_and_needed():
    """Every difference is named in README.md's list, and every parameter
    it excuses is still a difference (no stale allowance)."""
    import spartan_tpu

    readme = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    section = readme.split("Deliberate API differences", 1)[1].split("\n#", 1)[0]
    for key in DIFFERENCES:
        assert key in section, key
    used = set()
    for name in SIGNATURE_NAMES:
        jax_obj = getattr(spartan_tpu, name)
        port = getattr(spartan_tpu_torch, name)
        pairs = [(name, jax_obj, port)] if not inspect.isclass(jax_obj) else [
            (f"{name}.{a}", getattr(jax_obj, a), getattr(port, a, None))
            for a, _ in _public_methods(jax_obj)]
        for label, jf, pf in pairs:
            if pf is None:
                continue
            jn = {p.name for p in _params(jf)}
            pn = {p.name for p in _params(pf)}
            used |= {(label, n) for n in jn - pn} | {("*", n) for n in pn - jn}
    assert set(EXCUSED) <= used, set(EXCUSED) - used


# -- the R1CS shape and the entries form ---------------------------------------

NUM_CONS, NUM_VARS, NUM_INPUTS = 8, 8, 1


def _random_mats(seed: int):
    """A, B, C as (rows, cols, vals): repeated rows, an empty row, and
    values at and above p (reduced by every form)."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(3):
        rows = np.repeat(np.arange(NUM_CONS), rng.integers(0, 4, size=NUM_CONS))
        cols = rng.integers(0, 2 * NUM_VARS, size=rows.size)
        vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(rows.size)]
        if vals:
            vals[0] = FR_MOD
        mats.append((rows.tolist(), cols.tolist(), vals))
    return mats


def _shapes(pkg: str, mats) -> dict:
    """One shape of ``mats`` built from tuples, from SparseMatEntry lists and
    through from_arrays, in the package ``pkg``."""
    r1cs = importlib.import_module(f"{pkg}.core.r1cs")
    sm = importlib.import_module(f"{pkg}.core.sparse_mlpoly")
    nx, ny = 3, 4
    tuples = [list(zip(*m)) for m in mats]
    out = {"tuples": r1cs.R1CSShape(NUM_CONS, NUM_VARS, NUM_INPUTS, *tuples)}
    for form in ("entries", "arrays"):
        shape = r1cs.R1CSShape(NUM_CONS, NUM_VARS, NUM_INPUTS, [], [], [])
        polys = []
        for rows, cols, vals in mats:
            if form == "entries":
                polys.append(sm.SparseMatPolynomial(
                    nx, ny, [sm.SparseMatEntry(r, c, v) for r, c, v in zip(rows, cols, vals)]))
            else:
                polys.append(sm.SparseMatPolynomial.from_arrays(nx, ny, rows, cols, vals))
        shape.A, shape.B, shape.C = polys
        out[form] = shape
    return out


def _entry(e):
    return (e.row, e.col, e.val)


@pytest.mark.parametrize("form", ["tuples", "entries", "arrays"])
def test_shape_forms_match_jax(form):
    mats = _random_mats(11)
    port = _shapes("spartan_tpu_torch", mats)
    jax_shapes = _shapes("spartan_tpu", mats)
    shape, jshape = port[form], jax_shapes[form]
    assert shape.get_digest() == jshape.get_digest() == jax_shapes["tuples"].get_digest()
    assert (shape.get_num_cons(), shape.get_num_vars(), shape.get_num_inputs()) == \
        (jshape.get_num_cons(), jshape.get_num_vars(), jshape.get_num_inputs()) == \
        (NUM_CONS, NUM_VARS, NUM_INPUTS)
    for mat, jmat in ((shape.A, jshape.A), (shape.B, jshape.B), (shape.C, jshape.C)):
        assert len(mat.M) == len(jmat.M) == mat.num_entries() == jmat.num_entries()
        assert [_entry(e) for e in mat.M] == [_entry(e) for e in jmat.M]
        assert [_entry(mat.M[i]) for i in range(len(mat.M))] == \
            [_entry(jmat.M[i]) for i in range(len(jmat.M))]
        assert all(0 <= e.val < FR_MOD for e in mat.M)


# -- eq and eval tables -----------------------------------------------------------

@pytest.mark.parametrize("ell", [0, 3, 12])
def test_eq_evals_match_jax(ell):
    """At ell = 12 the table (4096 entries) is above HOST_N: k_eq_evals in
    both packages."""
    from spartan_tpu.core.mle import EqPolynomial as JEq

    rng = random.Random(ell)
    r = [rng.randrange(FR_MOD) for _ in range(ell)]
    assert ((1 << ell) > HP.HOST_N) == (ell == 12)
    got = spartan_tpu_torch.EqPolynomial(r).evals(device="cpu")
    assert got == JEq(r).evals() == HP.eq_evals(r)


def test_compute_eval_table_sparse_matches_jax():
    from spartan_tpu.core.sparse_mlpoly import SparseMatPolynomial as JSparse

    rng = np.random.default_rng(7)
    num_rows, num_cols = 1 << 6, 1 << 7
    rows = np.repeat(np.arange(num_rows), rng.integers(0, 5, size=num_rows))
    cols = rng.integers(0, num_cols, size=rows.size)
    vals = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(rows.size)]
    evals = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(num_rows)]
    poly = spartan_tpu_torch.SparseMatPolynomial.from_arrays(6, 7, rows, cols, vals)
    got = poly.compute_eval_table_sparse(evals, num_rows, num_cols, device="cpu")
    want = [0] * num_cols
    for r, c, v in zip(rows.tolist(), cols.tolist(), vals):
        want[c] = (want[c] + evals[r] * v) % FR_MOD
    jgot = JSparse.from_arrays(6, 7, rows, cols, vals).compute_eval_table_sparse(
        evals, num_rows, num_cols)
    assert got == jgot == want


def test_no_cpu_fallback_without_a_card():
    """Without device=, the new host-list entry points run on the card, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    poly = spartan_tpu_torch.SparseMatPolynomial.from_arrays(1, 1, [0], [1], [3])
    with pytest.raises(RuntimeError, match="CUDA"):
        poly.compute_eval_table_sparse([1, 2], 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        spartan_tpu_torch.EqPolynomial([5] * 12).evals()


# -- secure generators --------------------------------------------------------------

@pytest.mark.parametrize("path", ["host", "device"])
def test_secure_gens_match_jax(path, tmp_path, monkeypatch):
    """secure=True: the same affine points as JAX's, different from the
    default derivation's, cached under a key of their own (the second
    construction derives nothing), and a commit over them has JAX's bytes,
    through the host C MSM or (HOST_MSM_N lowered) the MSM's plain versions."""
    from spartan_tpu.core import commitments as JCM

    port_dir = tmp_path / "port"
    port_dir.mkdir()
    monkeypatch.setattr(CM, "_gens_cache_dir", lambda: str(port_dir))
    monkeypatch.setenv("SPARTAN_TPU_GENS_CACHE", str(tmp_path / "jax"))
    gens = spartan_tpu_torch.MultiCommitGens(8, b"t", secure=True, device="cpu")
    jgens = JCM.MultiCommitGens(8, b"t", secure=True)
    pts, h = gens.host_points()
    jpts, jh = jgens.host_points()
    assert (pts, h) == (jpts, jh)

    default = spartan_tpu_torch.MultiCommitGens(8, b"t", device="cpu")
    dpts, dh = default.host_points()
    assert all(a != b for a, b in zip(pts + [h], dpts + [dh]))
    assert len(os.listdir(port_dir)) == 2

    def refuse(*_a):
        raise AssertionError("derived again instead of read from the cache")

    monkeypatch.setattr(CM.MultiCommitGens, "_derive_secure", staticmethod(refuse))
    again = spartan_tpu_torch.MultiCommitGens(8, b"t", secure=True, device="cpu")
    assert again.host_points() == (pts, h)

    if path == "device":
        monkeypatch.setattr(HP, "HOST_MSM_N", 0)
    rng = random.Random(3)
    values = [rng.randrange(FR_MOD) for _ in range(8)]
    blind = rng.randrange(FR_MOD)
    got = CM.commit(values, blind, gens).compress()
    assert got == JCM.commit(values, blind, jgens).compress()


# -- README's usage example -------------------------------------------------------

def _example_circuit():
    """An 8-constraint satisfiable circuit as (row, col, val) triplets."""
    rng = random.Random(31337)
    num_cons, num_vars, num_inputs = 8, 8, 1
    vars_ = [rng.randrange(FR_MOD) for _ in range(num_vars)]
    inputs = [rng.randrange(FR_MOD) for _ in range(num_inputs)]
    z = vars_ + [1] + inputs
    A, B, C = [], [], []
    for i in range(num_cons):
        ca, cb = rng.randrange(len(z)), rng.randrange(len(z))
        va, vb = rng.randrange(1, FR_MOD), rng.randrange(1, FR_MOD)
        A.append((i, ca, va))
        B.append((i, cb, vb))
        C.append((i, num_vars, va * z[ca] % FR_MOD * vb % FR_MOD * z[cb] % FR_MOD))
    return num_cons, num_vars, num_inputs, A, B, C, vars_, inputs


def _readme_example(pkg: str, **device):
    """README.md's usage example with ``pkg``'s import line (``device``:
    the port's device="cpu"), proved with a seeded tape."""
    S = importlib.import_module(pkg)
    Instance, VarsAssignment, InputsAssignment = S.Instance, S.VarsAssignment, \
        S.InputsAssignment
    SNARK, SNARKGens, Transcript, RandomTape = S.SNARK, S.SNARKGens, S.Transcript, \
        S.RandomTape
    num_cons, num_vars, num_inputs, A, B, C, vars_, inputs = _example_circuit()

    inst = Instance.new(num_cons, num_vars, num_inputs, A, B, C)
    max_nnz = max(len(inst.inst.A.M), len(inst.inst.B.M), len(inst.inst.C.M))
    gens = SNARKGens(num_cons, num_vars, num_inputs, max_nnz, **device)
    comm, decomm = SNARK.encode(inst, gens)
    vars_, inputs = VarsAssignment(vars_), InputsAssignment(inputs)
    proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(b"demo"),
                        RandomTape(b"demo", seed=bytes([9]) * 32))
    proof.verify(comm, inputs, Transcript(b"demo"), gens)
    return {"gens": gens, "comm": comm, "proof": proof, "inputs": inputs}


def test_readme_example_matches_jax():
    from spartan_tpu.core.r1cs import R1CSCommitment as JComm
    from spartan_tpu.snark import SNARK as JSNARK
    from spartan_tpu.utils.serialization import deserialize as jax_deserialize
    from spartan_tpu.utils.serialization import serialize as jax_serialize
    from spartan_tpu.utils.transcript import Transcript as JTranscript
    from spartan_tpu_torch.core.r1cs import R1CSCommitment
    from spartan_tpu_torch.snark import SNARK
    from spartan_tpu_torch.utils.serialization import deserialize, serialize
    from spartan_tpu_torch.utils.transcript import Transcript

    port = _readme_example("spartan_tpu_torch", device="cpu")
    jax_run = _readme_example("spartan_tpu")
    raw, jraw = serialize(port["proof"]), jax_serialize(jax_run["proof"])
    assert raw == jraw
    assert serialize(port["comm"]) == jax_serialize(jax_run["comm"])
    # each verifier accepts the other's proof, from bytes
    jax_deserialize(JSNARK, raw).verify(
        jax_deserialize(JComm, serialize(port["comm"])), jax_run["inputs"],
        JTranscript(b"demo"), jax_run["gens"])
    deserialize(SNARK, jraw).verify(
        deserialize(R1CSCommitment, jax_serialize(jax_run["comm"])), port["inputs"],
        Transcript(b"demo"), port["gens"])
