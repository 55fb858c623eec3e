"""Sharded proving (``spartan_tpu_torch.parallel``) on CPU ranks.

The counterpart of ``tests/test_parallel.py``: worlds of gloo ranks on the
CPU (4 ranks, 2 for the NIZK, and a world of 1), spawned once for the
module, each rank on one torch thread, prove and commit with ``mesh=`` and
hand their results back through a temporary directory. The same inputs,
made from seeds, go through the port on one device and through the JAX
package (on its virtual CPU devices where it shards); every sharded result
must equal both bit for bit: field values, affine points, commitment and
proof bytes, and every rank's bytes must be the same. Inside the ranks the
host-path thresholds are lowered so that the mesh engages at these sizes;
each rank reports which sharded paths ran. The worker functions below run
in the ranks, so this module imports JAX only inside the tests.
"""

import collections
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.parallel.launch import spawn

from torch_threads import _one_thread  # noqa: F401

D = 4
N_TABLE = 32          # sumcheck round / strided tables
TREE_LEAVES = 256
ROWS_L, ROWS_R = 6, 8  # commit_rows: L not a multiple of D
KZG_N = 64
MSM_N = 32
ONE_ROW_MSM_N, ONE_ROW_C = 1 << 10, 7   # the world of 2's one-launch msm_sharded
SNARK_LOG2 = 4
NIZK_LOG2 = 5
LABEL = b"torch_mesh"
TAPE_SEED = bytes([0x0B]) * 32
SRS_SEED = 7


def _ints(seed: int, n: int) -> list[int]:
    """n field elements from a numpy generator."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(x) << (32 * i) for i, x in enumerate(row)) % FR_MOD for row in w]


def _tables(k: int, n: int, seed: int) -> list[list[int]]:
    return [_ints(seed + i, n) for i in range(k)]


# ---------------------------------------------------------------------------
# what the ranks run (no JAX here)
# ---------------------------------------------------------------------------

class _Engaged:
    """Counts the sharded paths a rank takes, by wrapping their entries."""

    def __init__(self):
        from spartan_tpu_torch.core import sumcheck as SC
        from spartan_tpu_torch.parallel import sumcheck_sharded as SS

        self.n = collections.Counter()
        self._wrap(SC._MeshTables, "__init__", "zk_tables")
        self._wrap(SC._BatchedMeshTables, "__init__", "batched_tables")
        self._wrap(SS, "bound_sharded", "bound")
        self._wrap(SS, "make_tree_level", "tree")

    def _wrap(self, owner, name, key):
        orig = getattr(owner, name)

        def counted(*a, **k):
            self.n[key] += 1
            return orig(*a, **k)

        setattr(owner, name, counted)


def _snark_in_rank(mesh, pcs: str, srs_path: str) -> dict:
    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.core import hostpath as HP
    from spartan_tpu_torch.core import sumcheck_fused as SF
    from spartan_tpu_torch.io.keyless_bench import synthetic
    from spartan_tpu_torch.snark import SNARK, SNARKGens
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import serialize
    from spartan_tpu_torch.utils.transcript import Transcript

    HP.HOST_N, SF.SMALL_BUCKET_N = 4, 8
    seen = _Engaged()
    inst, vars_, inputs, nnz = synthetic(SNARK_LOG2, seed=3)
    n = inst.inst.num_cons
    gens = SNARKGens(n, n, 1, nnz, device=mesh.device,
                     config=SpartanConfig(pcs=pcs, srs_path=srs_path))
    comm, decomm = SNARK.encode(inst, gens, mesh=mesh)
    proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(LABEL),
                        RandomTape(b"snark_proof", seed=TAPE_SEED), mesh=mesh)
    proof.verify(comm, inputs, Transcript(LABEL), gens)
    return {"comm": serialize(comm), "proof": serialize(proof), "engaged": dict(seen.n)}


def _world4(mesh, srs_path: str) -> dict:
    """Every 4-rank case; one spawn for all of them."""
    from spartan_tpu_torch.core import hostpath as HP
    from spartan_tpu_torch.core.commitments import MultiCommitGens, commit_rows
    from spartan_tpu_torch.core.mle import DensePolynomial
    from spartan_tpu_torch.core.product_tree import ProductCircuit
    from spartan_tpu_torch.ops import curve as CU
    from spartan_tpu_torch.ops import curve_host as CH
    from spartan_tpu_torch.parallel import (
        gather_table,
        gather_unstride,
        make_cubic_round,
        msm_sharded,
        shard_strided,
        shard_table,
    )
    from spartan_tpu_torch.pcs.kzg import KZGProof, KZGSrs, _commit_msm

    assert mesh.size == D and mesh.backend == "gloo" and mesh.device.type == "cpu"
    out = {"rank": mesh.rank}

    # strided shards and gathers
    x = F.encode_fr(_ints(1, N_TABLE), device=mesh.device)
    out["gather_table"] = bool(torch.equal(gather_table(mesh, shard_table(mesh, x)), x))
    out["gather_unstride"] = bool(torch.equal(gather_unstride(mesh, shard_strided(mesh, x)), x))

    # one sharded cubic round
    tabs = [F.encode_fr(t, device=mesh.device) for t in _tables(4, N_TABLE, 10)]
    r = F.encode_fr(_ints(20, 1), device=mesh.device)[0]
    e0, e2, e3, *folded = make_cubic_round(mesh, *(shard_strided(mesh, t) for t in tabs), r)
    out["cubic_evals"] = F.decode_fr(torch.stack((e0, e2, e3)))
    out["cubic_folded"] = [F.decode_fr(gather_unstride(mesh, t)) for t in folded]

    # product tree built on the shards
    HP.HOST_N = 16
    leaves = F.encode_fr([v or 1 for v in _ints(30, TREE_LEAVES)], device=mesh.device)
    circ = ProductCircuit(DensePolynomial(leaves), mesh=mesh)
    out["tree_sharded"] = circ._mesh is not None
    out["tree_layers"] = [[F.decode_fr(p.Z) for p in circ.layer(i)]
                          for i in range(circ.num_layers)]
    out["tree_eval"] = circ.evaluate()
    HP.HOST_N = 2048

    # Hyrax row commits, L not a multiple of D
    gens = MultiCommitGens(ROWS_R, b"test_commit_rows_sharded", device=mesh.device)
    Z = F.encode_fr(_ints(40, ROWS_L * ROWS_R), device=mesh.device).reshape(ROWS_L, ROWS_R, 8)
    blinds = F.encode_fr(_ints(41, ROWS_L), device=mesh.device)
    out["commit_rows"] = CU.decode_points(commit_rows(Z, blinds, gens, mesh=mesh))

    # KZG commit and quotient MSMs with the points sharded
    HP.HOST_COMMIT_POINTS = 8
    srs = KZGSrs.setup_from_seed(KZG_N, SRS_SEED, device=mesh.device)
    coeffs = F.encode_fr(_ints(50, KZG_N), device=mesh.device)
    point = _ints(51, 1)[0]
    proof, ev = KZGProof.prove(coeffs, point, srs, mesh=mesh)
    out["kzg"] = (_commit_msm(srs, coeffs, mesh=mesh).compress(), proof.proof.compress(), ev)
    HP.HOST_COMMIT_POINTS = 16384

    # the window-gather MSM against the host
    rng = random.Random(60)
    pts = [CH.scalar_mul(rng.randrange(1, 1 << 50), CH.GEN) for _ in range(MSM_N)]
    sc = F.encode_canonical(_ints(61, MSM_N), mesh.device)
    enc = CU.encode_points_affine(pts, mesh.device)
    acc = msm_sharded(mesh, tuple(shard_table(mesh, a) for a in enc), shard_table(mesh, sc),
                      c=4)
    out["msm"] = (CU.decode_points(tuple(a.unsqueeze(0) for a in acc))[0], pts)

    out["snark_hyrax"] = _snark_in_rank(mesh, "hyrax", srs_path)
    out["snark_kzg"] = _snark_in_rank(mesh, "kzg", srs_path)
    return out


def _nizk_in_rank(mesh) -> dict:
    from spartan_tpu_torch.core import hostpath as HP
    from spartan_tpu_torch.io.keyless_bench import synthetic
    from spartan_tpu_torch.snark import NIZK, NIZKGens
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import serialize
    from spartan_tpu_torch.utils.transcript import Transcript

    HP.HOST_N = 4
    seen = _Engaged()
    inst, vars_, inputs, _ = synthetic(NIZK_LOG2, seed=9)
    n = inst.inst.num_cons
    gens = NIZKGens(n, n, 1, device=mesh.device)
    proof = NIZK.prove(inst, vars_, inputs, gens, Transcript(LABEL),
                       RandomTape(b"proof", seed=TAPE_SEED), mesh=mesh)
    proof.verify(inst, inputs, Transcript(LABEL), gens)
    return {"proof": serialize(proof), "engaged": dict(seen.n), "size": mesh.size,
            "msm": _one_row_msm_in_rank(mesh)}


def _one_row_msm_in_rank(mesh) -> tuple:
    """msm_sharded of ONE_ROW_MSM_N points at c = ONE_ROW_C with
    CHUNK_BUDGET lowered to 8 digit rows: H3 fills the rank's bucket table
    in chunks, H4 runs once. Returns the affine sum, the points and the
    bucket tables H4 was given."""
    from spartan_tpu_torch.ops import curve as CU
    from spartan_tpu_torch.ops import curve_host as CH
    from spartan_tpu_torch.ops import msm as M
    from spartan_tpu_torch.parallel import msm_sharded, shard_table

    rng = random.Random(62)
    pts = [CH.scalar_mul(rng.randrange(1, 1 << 50), CH.GEN) for _ in range(32)]
    pts = [pts[i % 32] for i in range(ONE_ROW_MSM_N)]
    sc = F.encode_canonical(_ints(63, ONE_ROW_MSM_N), mesh.device)
    enc = CU.encode_points_affine(pts, mesh.device)
    saved, orig = M.CHUNK_BUDGET, M.weighted_sums
    tables = []
    M.CHUNK_BUDGET = 8 * ONE_ROW_MSM_N // mesh.size
    M.weighted_sums = lambda b, c: tables.append(tuple(b[0].shape)) or orig(b, c)
    try:
        acc = msm_sharded(mesh, tuple(shard_table(mesh, a) for a in enc), shard_table(mesh, sc),
                          c=ONE_ROW_C)
    finally:
        M.CHUNK_BUDGET, M.weighted_sums = saved, orig
    return CU.decode_points(tuple(a.unsqueeze(0) for a in acc))[0], pts, tables


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def _srs_size() -> int:
    from spartan_tpu_torch.utils.math import log_2, next_power_of_two, pow2

    nnz = 3 << SNARK_LOG2
    return pow2(log_2(max(2, next_power_of_two(nnz))) + 3) + 1


@pytest.fixture(scope="module")
def srs_path(tmp_path_factory):
    """The KZG SRS file the ranks load (made once, before they start)."""
    from spartan_tpu_torch.pcs.kzg import KZGSrs

    path = str(tmp_path_factory.mktemp("srs") / "srs.npz")
    KZGSrs.load_or_generate(path, _srs_size(), 0xDEADBEEF, device="cpu")
    return path


@pytest.fixture(scope="module")
def worlds(srs_path):
    """The three worlds, started together in the background while the
    tests make their single-device references: {4: ..., 2: ..., 1: ...},
    each a future of the ranks' results."""
    with ThreadPoolExecutor(3) as pool:
        yield {4: pool.submit(spawn, _world4, D, srs_path, device="cpu", threads=1),
               **{d: pool.submit(spawn, _nizk_in_rank, d, device="cpu", threads=1)
                  for d in (2, 1)}}


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4].result()


def _jax_mesh():
    import jax

    from spartan_tpu.parallel import make_mesh

    assert len(jax.devices()) >= D
    return make_mesh(D)


def _single_snark(pcs: str, srs_path: str) -> dict:
    """The same SNARK on one device: the port (default thresholds) and the
    JAX package."""
    from spartan_tpu import snark as JS
    from spartan_tpu.config import SpartanConfig as JConfig
    from spartan_tpu.io.keyless_bench import synthetic as jsynthetic
    from spartan_tpu.utils.random_tape import RandomTape as JTape
    from spartan_tpu.utils.serialization import serialize as jserialize
    from spartan_tpu.utils.transcript import Transcript as JTranscript
    from spartan_tpu_torch.config import SpartanConfig
    from spartan_tpu_torch.io.keyless_bench import synthetic
    from spartan_tpu_torch.snark import SNARK, SNARKGens
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import serialize
    from spartan_tpu_torch.utils.transcript import Transcript

    inst, vars_, inputs, nnz = synthetic(SNARK_LOG2, seed=3)
    n = inst.inst.num_cons
    gens = SNARKGens(n, n, 1, nnz, device="cpu", config=SpartanConfig(pcs=pcs,
                                                                     srs_path=srs_path))
    comm, decomm = SNARK.encode(inst, gens)
    proof = SNARK.prove(inst, comm, decomm, vars_, inputs, gens, Transcript(LABEL),
                        RandomTape(b"snark_proof", seed=TAPE_SEED))
    jinst, jvars, jinputs, _ = jsynthetic(SNARK_LOG2, seed=3)
    jgens = JS.SNARKGens(n, n, 1, nnz, config=JConfig(pcs=pcs, srs_path=srs_path))
    jcomm, jdecomm = JS.SNARK.encode(jinst, jgens)
    jproof = JS.SNARK.prove(jinst, jcomm, jdecomm, jvars, jinputs, jgens, JTranscript(LABEL),
                            JTape(b"snark_proof", seed=TAPE_SEED))
    return {"comm": serialize(comm), "proof": serialize(proof), "jcomm": jserialize(jcomm),
            "jproof": jserialize(jproof), "gens": gens, "inputs": inputs}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_make_mesh_without_process_group_raises(monkeypatch):
    from spartan_tpu_torch.parallel import init_distributed, make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed()



def test_strided_roundtrip_matches_jax():
    import jax.numpy as jnp

    from spartan_tpu.ops import field_jax as JF
    from spartan_tpu.parallel import to_strided as jto_strided
    from spartan_tpu_torch.parallel import from_strided, to_strided

    vals = _ints(1, N_TABLE)
    s = to_strided(F.encode_fr(vals, device="cpu"), D)
    js = jto_strided(jnp.asarray(JF.encode_fr(vals)), D)
    assert s.shape == (D, N_TABLE // D, 8)
    assert [F.decode_fr(s[d]) for d in range(D)] == [JF.decode_fr(js[d]) for d in range(D)]
    assert F.decode_fr(from_strided(s)) == vals



def test_mesh_device_must_match_gens():
    from spartan_tpu_torch.parallel.mesh import Mesh, check_device

    check_device(Mesh(2, 0, torch.device("cpu"), "gloo"), "cpu")
    with pytest.raises(ValueError, match="differs"):
        check_device(Mesh(2, 0, torch.device("cpu"), "gloo"), "meta")



def test_backend_rule():
    from spartan_tpu_torch.parallel.mesh import default_backend, rank_device

    assert default_backend(torch.device("cpu"), 4) == "gloo"
    assert rank_device("cpu", 3) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rank_device(None, 0)


@pytest.mark.parametrize("pcs", ["hyrax", "kzg"])
def test_sharded_snark_bit_identical(worlds, srs_path, pcs):
    """The SNARK proved by 4 ranks (each product sumcheck handed from the
    mesh to the fused driver) equals the port's and the JAX package's
    single-device commitment and proof, the same on every rank, and
    verifies."""
    from spartan_tpu_torch.core.r1cs import R1CSCommitment
    from spartan_tpu_torch.snark import SNARK
    from spartan_tpu_torch.utils.serialization import deserialize
    from spartan_tpu_torch.utils.transcript import Transcript

    ref = _single_snark(pcs, srs_path)
    assert ref["comm"] == ref["jcomm"] and ref["proof"] == ref["jproof"]
    ranks = [w[f"snark_{pcs}"] for w in worlds[4].result()]
    for got in ranks:
        assert got["comm"] == ref["comm"]
        assert got["proof"] == ref["proof"]
        # the mesh engaged in both ZK phases, the product layers and the trees
        assert got["engaged"].get("zk_tables") == 2
        assert got["engaged"].get("batched_tables", 0) > 0
        assert got["engaged"].get("tree", 0) > 0
        assert got["engaged"].get("bound", 0) > 0
    proof = deserialize(SNARK, ranks[1]["proof"], pcs=pcs)
    comm = deserialize(R1CSCommitment, ranks[1]["comm"], pcs=pcs)
    proof.verify(comm, ref["inputs"], Transcript(LABEL), ref["gens"])



def test_sharded_nizk_bit_identical(worlds):
    """The NIZK proved by 2 ranks equals the port's and the JAX package's
    single-device proofs on every rank; a world of 1 takes the unsharded
    path and makes the same bytes."""
    from spartan_tpu import snark as JS
    from spartan_tpu.io.keyless_bench import synthetic as jsynthetic
    from spartan_tpu.utils.random_tape import RandomTape as JTape
    from spartan_tpu.utils.serialization import serialize as jserialize
    from spartan_tpu.utils.transcript import Transcript as JTranscript
    from spartan_tpu_torch.io.keyless_bench import synthetic
    from spartan_tpu_torch.snark import NIZK, NIZKGens
    from spartan_tpu_torch.utils.random_tape import RandomTape
    from spartan_tpu_torch.utils.serialization import deserialize, serialize
    from spartan_tpu_torch.utils.transcript import Transcript

    inst, vars_, inputs, _ = synthetic(NIZK_LOG2, seed=9)
    n = inst.inst.num_cons
    gens = NIZKGens(n, n, 1, device="cpu")
    ref = serialize(NIZK.prove(inst, vars_, inputs, gens, Transcript(LABEL),
                               RandomTape(b"proof", seed=TAPE_SEED)))
    jinst, jvars, jinputs, _ = jsynthetic(NIZK_LOG2, seed=9)
    jref = jserialize(JS.NIZK.prove(jinst, jvars, jinputs, JS.NIZKGens(n, n, 1),
                                    JTranscript(LABEL), JTape(b"proof", seed=TAPE_SEED)))
    assert ref == jref
    two, one = worlds[2].result(), worlds[1].result()
    for got in two:
        assert got["size"] == 2 and got["proof"] == ref
        assert got["engaged"].get("zk_tables") == 2 and got["engaged"].get("bound") == 1
    assert one[0]["size"] == 1 and one[0]["proof"] == ref
    assert not one[0]["engaged"]
    deserialize(NIZK, two[1]["proof"]).verify(inst, inputs, Transcript(LABEL), gens)


def test_sharded_one_row_msm_one_h4_call(worlds):
    """In the worlds of 2 and 1, msm_sharded of 2^10 points: each rank's
    windows go to H4 in one call (its [W, 127] bucket table, filled by H3
    in chunks of 8 rows), and the replicated sum equals the host C MSM."""
    from spartan_tpu_torch.ops import curve_host as CH

    W = -(-254 // ONE_ROW_C)
    for world in (worlds[2].result(), worlds[1].result()):
        for got in world:
            acc, pts, tables = got["msm"]
            assert tables == [(W, (1 << ONE_ROW_C) - 1, 8)]
            assert acc == CH.msm(_ints(63, ONE_ROW_MSM_N), pts)



def test_sharded_cubic_round_matches_jax_and_single_device(worlds):
    import jax

    from spartan_tpu.ops import field_jax as JF
    from spartan_tpu.parallel import from_strided as jfrom_strided
    from spartan_tpu.parallel import make_cubic_round as jmake_cubic_round
    from spartan_tpu.parallel import shard_table as jshard_table
    from spartan_tpu.parallel import to_strided as jto_strided
    from spartan_tpu_torch.ops import sumcheck_kernels as SK

    tabs = _tables(4, N_TABLE, 10)
    r = _ints(20, 1)[0]
    port = [F.encode_fr(t, device="cpu") for t in tabs]
    r_port = F.encode_fr([r], device="cpu")[0]
    evals = F.decode_fr(SK.additive_evals_plain(*port))
    folded = [F.decode_fr(SK.fold_plain(t, r_port)) for t in port]

    mesh = _jax_mesh()
    jin = [jshard_table(mesh, jto_strided(JF.encode_fr(t), D)) for t in tabs]
    e0, e2, e3, *jfolded = jax.jit(jmake_cubic_round(mesh))(*jin, JF.encode_fr([r])[0])
    jevals = [JF.decode_fr(e[None])[0] for e in (e0, e2, e3)]
    jfolded = [JF.decode_fr(jfrom_strided(t)) for t in jfolded]

    assert evals == jevals
    assert folded == jfolded
    for w in worlds[4].result():
        assert w["cubic_evals"] == evals
        assert w["cubic_folded"] == folded



def test_gather_table_and_unstride_natural_order(world4):
    assert all(w["gather_table"] and w["gather_unstride"] for w in world4)



def test_sharded_product_tree_matches(world4):
    from spartan_tpu_torch.core.mle import DensePolynomial
    from spartan_tpu_torch.core.product_tree import ProductCircuit

    leaves = F.encode_fr([v or 1 for v in _ints(30, TREE_LEAVES)], device="cpu")
    c = ProductCircuit(DensePolynomial(leaves))
    layers = [[F.decode_fr(p.Z) for p in c.layer(i)] for i in range(c.num_layers)]
    for w in world4:
        assert w["tree_sharded"]
        assert w["tree_layers"] == layers
        assert w["tree_eval"] == c.evaluate()



def test_sharded_commit_rows_matches(world4):
    from spartan_tpu_torch.core.commitments import MultiCommitGens, commit_rows
    from spartan_tpu_torch.ops import curve as CU

    gens = MultiCommitGens(ROWS_R, b"test_commit_rows_sharded", device="cpu")
    Z = F.encode_fr(_ints(40, ROWS_L * ROWS_R), device="cpu").reshape(ROWS_L, ROWS_R, 8)
    blinds = F.encode_fr(_ints(41, ROWS_L), device="cpu")
    ref = CU.decode_points(commit_rows(Z, blinds, gens))
    assert len(ref) == ROWS_L
    for w in world4:
        assert w["commit_rows"] == ref



def test_sharded_kzg_matches(world4):
    from spartan_tpu_torch.pcs.kzg import KZGCommitment, KZGProof, KZGSrs, _commit_msm

    srs = KZGSrs.setup_from_seed(KZG_N, SRS_SEED, device="cpu")
    coeffs = F.encode_fr(_ints(50, KZG_N), device="cpu")
    point = _ints(51, 1)[0]
    comm = _commit_msm(srs, coeffs)
    proof, ev = KZGProof.prove(coeffs, point, srs)
    assert proof.verify(KZGCommitment(comm), point, ev, srs)
    for w in world4:
        assert w["kzg"] == (comm.compress(), proof.proof.compress(), ev)



def test_sharded_msm_matches_host(world4):
    from spartan_tpu_torch.ops import curve_host as CH

    for w in world4:
        got, pts = w["msm"]
        assert got == CH.msm(_ints(61, MSM_N), pts)

