"""The sparse-matrix evaluation proof (lookup argument), SNARK mode.

Counterpart of ``spartan_tpu/core/sparse_mlpoly_full.py`` (reference
sparse_mlpoly_full.rs). Proves that committed sparse matrices A, B, C
evaluate to claimed values at (rx, ry) by offline memory checking:

- ``AddrTimestamps``: read/write timestamps as a rank within equal-address
  runs of a stable sort (numpy, at preprocessing), the reference's
  sequential loop (sparse_mlpoly_full.rs:211-243) with the same values;
- ``Derefs``: mem[addr] gathered on the device, committed with Hyrax (the
  H3/H4 MSM) or, with ``pcs="kzg"``, with KZG (one MSM of the whole
  table, opened at a transcript point: ``pcs/kzg.py``);
- the hash layer h(a, v, t) = t r^2 + v r + a - gamma on H1;
- the grand products of the multisets as batched product-tree proofs,
  whose layered sumchecks run on S1/S2;
- the hash-layer openings batched n-to-1 into three Hyrax opening proofs.

Index and timestamp tables are encoded on the device from int64 arrays
(``DensePolynomial.from_usize``) whenever they are needed, never through
Python ints, and are not kept between phases. Transcript labels and orders
match the reference byte for byte in both modes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch.core.mle import (
    DensePolynomial,
    EqPolynomial,
    IdentityPolynomial,
    batch_evaluate,
)
from spartan_tpu_torch.core.product_tree import (
    DotProductCircuit,
    ProductCircuit,
    ProductCircuitEvalProofBatched,
    batch_circuit_evals,
    batch_dotp_evals,
)
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.pcs.hyrax import PolyCommitment, PolyCommitmentGens, PolyEvalProof, commit_poly
from spartan_tpu_torch.utils.errors import ProofVerifyError, fmt_claims
from spartan_tpu_torch.utils.math import log_2, next_power_of_two, pow2
from spartan_tpu_torch.utils.timer import Timer

fr = F.fr


def k_hash_layer(addr, val, ts, r_hash, r_hash_sqr, gamma):
    """h(a, v, t) - gamma = t r^2 + v r + a - gamma, elementwise [N, 8]."""
    h = fr.add(fr.add(fr.mul(ts, r_hash_sqr), fr.mul(val, r_hash)), addr)
    return fr.sub(h, gamma)


def k_gather(mem, addr):
    """mem[addr]: mem [C, 8], addr [N] int64 -> [N, 8]."""
    return mem[addr]


# ---------------------------------------------------------------------------
# address timestamps (offline memory checking preprocessing)
# ---------------------------------------------------------------------------

class AddrTimestamps:
    """Read/write timestamps of a batch of address streams
    (sparse_mlpoly_full.rs:211-243), including the audit counter carried
    over between instances. The limb tables are built on demand."""

    def __init__(self, num_cells: int, num_ops: int, ops_addr: list[np.ndarray], device):
        self.num_cells = num_cells
        self.num_ops = num_ops
        self.device = device
        self.ops_addr_usize = [np.asarray(a, dtype=np.int64) for a in ops_addr]
        for a in self.ops_addr_usize:
            assert a.shape == (num_ops,)
            assert a.max(initial=0) < num_cells

        base = np.zeros(num_cells, dtype=np.int64)
        read_ts_list = []
        for addr in self.ops_addr_usize:
            order = np.argsort(addr, kind="stable")
            sa = addr[order]
            is_new = np.ones(num_ops, dtype=bool)
            if num_ops > 1:
                is_new[1:] = sa[1:] != sa[:-1]
            run_starts = np.flatnonzero(is_new)
            run_ids = np.cumsum(is_new) - 1
            rank = np.arange(num_ops) - run_starts[run_ids]
            read_ts = np.empty(num_ops, dtype=np.int64)
            read_ts[order] = base[sa] + rank
            read_ts_list.append(read_ts)
            base += np.bincount(addr, minlength=num_cells)

        self.read_ts_usize = read_ts_list
        self.audit_ts_usize = base
        self._addr_dev = [torch.from_numpy(a).to(device) for a in self.ops_addr_usize]

    def ops_addr(self) -> list[DensePolynomial]:
        with Timer("addr_ts_tables"):
            return [DensePolynomial.from_usize(a, self.device) for a in self.ops_addr_usize]

    def read_ts(self) -> list[DensePolynomial]:
        with Timer("addr_ts_tables"):
            return [DensePolynomial.from_usize(t, self.device) for t in self.read_ts_usize]

    def audit_ts(self) -> DensePolynomial:
        with Timer("addr_ts_tables"):
            return DensePolynomial.from_usize(self.audit_ts_usize, self.device)

    def deref(self, mem_val_dev) -> list[DensePolynomial]:
        """Gather mem[addr] per instance (sparse_mlpoly_full.rs:245-257)."""
        return [DensePolynomial(k_gather(mem_val_dev, a)) for a in self._addr_dev]


# ---------------------------------------------------------------------------
# dense representation + commitment
# ---------------------------------------------------------------------------

class MultiSparseMatPolynomialAsDense:
    """row/col AddrTimestamps + vals; the two combined polys are built on
    demand (sparse_mlpoly_full.rs:264-280)."""

    def __init__(self, batch_size, row: AddrTimestamps, col: AddrTimestamps,
                 val: list[DensePolynomial]):
        self.batch_size = batch_size
        self.row = row
        self.col = col
        self.val = val

    def comb_ops(self) -> DensePolynomial:
        return DensePolynomial.merge(
            self.row.ops_addr() + self.row.read_ts() +
            self.col.ops_addr() + self.col.read_ts() + self.val)

    def comb_mem(self) -> DensePolynomial:
        cm = self.row.audit_ts()
        cm.extend(self.col.audit_ts())
        return cm

    def deref(self, row_mem_dev, col_mem_dev) -> "Derefs":
        return Derefs(self.row.deref(row_mem_dev), self.col.deref(col_mem_dev))


def multi_sparse_to_dense_rep(sparse_polys, device=None) -> MultiSparseMatPolynomialAsDense:
    """sparse_mlpoly_full.rs:120-174. The values come from the matrices'
    device copies (one encoding, shared with the SpMVs of the prove)."""
    assert sparse_polys
    dev = DEV.current() if device is None else torch.device(device)
    nx = sparse_polys[0].num_vars_x
    ny = sparse_polys[0].num_vars_y
    for p in sparse_polys[1:]:
        assert p.num_vars_x == nx and p.num_vars_y == ny

    N = max(p.get_num_nz_entries() for p in sparse_polys)
    ops_row_vec, ops_col_vec, val_vec = [], [], []
    timer_vals = Timer(f"dense_rep_vals[N={N}]")
    for p in sparse_polys:
        n = len(p.vals)
        rows = np.zeros(N, dtype=np.int64)
        cols = np.zeros(N, dtype=np.int64)
        rows[:n] = p.rows
        cols[:n] = p.cols
        ops_row_vec.append(rows)
        ops_col_vec.append(cols)
        vals = torch.zeros((N, F.NUM_LIMBS), dtype=torch.int32, device=dev)
        vals[:n] = p.vals_device(dev)
        val_vec.append(DensePolynomial(vals))
    timer_vals.stop()

    num_mem_cells = pow2(max(nx, ny))
    timer_ts = Timer("dense_rep_timestamps")
    row = AddrTimestamps(num_mem_cells, N, ops_row_vec, dev)
    col = AddrTimestamps(num_mem_cells, N, ops_col_vec, dev)
    timer_ts.stop()

    return MultiSparseMatPolynomialAsDense(len(sparse_polys), row, col, val_vec)


class SparseMatPolyCommitmentGens:
    """Gens of the ops/mem/derefs polys (sparse_mlpoly_full.rs:602-631).

    ``pcs``: 'hyrax' (default) or 'kzg', the derefs commitment (the
    reference's compile-time feature flag); KZG without ``kzg_srs`` makes
    the seeded test SRS of the JAX package.
    """

    def __init__(self, label: bytes, num_vars_x: int, num_vars_y: int,
                 num_nz_entries: int, batch_size: int, pcs: str = "hyrax",
                 kzg_srs=None):
        if pcs not in ("hyrax", "kzg"):
            raise ValueError(f"unknown PCS mode: {pcs}")
        num_vars_ops = log_2(next_power_of_two(num_nz_entries)) + \
            log_2(next_power_of_two(batch_size * 5))
        num_vars_mem = max(num_vars_x, num_vars_y) + 1
        num_vars_derefs = log_2(next_power_of_two(num_nz_entries)) + \
            log_2(next_power_of_two(batch_size * 2))

        self.pcs = pcs
        self.gens_ops = PolyCommitmentGens(num_vars_ops, label)
        self.gens_mem = PolyCommitmentGens(num_vars_mem, label)
        if pcs == "hyrax":
            self.gens_derefs = PolyCommitmentGens(num_vars_derefs, label)
        else:
            from spartan_tpu_torch.pcs.kzg import KZGPolyCommitmentGens, KZGSrs

            if kzg_srs is None:
                kzg_srs = KZGSrs.setup_from_seed(pow2(num_vars_derefs) + 1, 0xDEADBEEF)
            self.gens_derefs = KZGPolyCommitmentGens(kzg_srs)


@dataclass
class SparseMatPolyCommitment:
    batch_size: int
    num_ops: int
    num_mem_cells: int
    comm_comb_ops: PolyCommitment
    comm_comb_mem: PolyCommitment

    def append_to_transcript(self, _label: bytes, transcript) -> None:
        transcript.append_u64(b"batch_size", self.batch_size)
        transcript.append_u64(b"num_ops", self.num_ops)
        transcript.append_u64(b"num_mem_cells", self.num_mem_cells)
        self.comm_comb_ops.append_to_transcript(b"comm_comb_ops", transcript)
        self.comm_comb_mem.append_to_transcript(b"comm_comb_mem", transcript)


def multi_commit(sparse_polys, gens: SparseMatPolyCommitmentGens, mesh=None):
    """(commitment, dense rep): the SNARK's encode (sparse_mlpoly_full.rs:176-197)."""
    timer_dense = Timer("multi_sparse_to_dense_rep")
    dense = multi_sparse_to_dense_rep(sparse_polys)
    timer_dense.stop()
    comb_ops = dense.comb_ops()
    timer_ops = Timer(f"commit_comb_ops[{comb_ops.len}]")
    comm_comb_ops, _ = commit_poly(comb_ops, gens.gens_ops, mesh=mesh)
    timer_ops.stop()
    del comb_ops
    comb_mem = dense.comb_mem()
    timer_mem = Timer(f"commit_comb_mem[{comb_mem.len}]")
    comm_comb_mem, _ = commit_poly(comb_mem, gens.gens_mem, mesh=mesh)
    timer_mem.stop()
    return (
        SparseMatPolyCommitment(
            batch_size=len(sparse_polys),
            num_mem_cells=dense.row.num_cells,
            num_ops=dense.row.num_ops,
            comm_comb_ops=comm_comb_ops,
            comm_comb_mem=comm_comb_mem,
        ),
        dense,
    )


# ---------------------------------------------------------------------------
# derefs
# ---------------------------------------------------------------------------

class Derefs:
    def __init__(self, row_ops_val: list[DensePolynomial], col_ops_val: list[DensePolynomial]):
        assert len(row_ops_val) == len(col_ops_val)
        self.row_ops_val = row_ops_val
        self.col_ops_val = col_ops_val

    def comb(self) -> DensePolynomial:
        return DensePolynomial.merge(self.row_ops_val + self.col_ops_val)

    def commit(self, gens, mesh=None) -> "DerefsCommitment":
        """Hyrax row commits, or one KZG commitment of the whole table."""
        if isinstance(gens, PolyCommitmentGens):
            comm, _ = commit_poly(self.comb(), gens, mesh=mesh)
            return DerefsCommitment(comm)
        return DerefsCommitment(gens.commit(self.comb(), mesh=mesh))


def _derefs_spec(hyrax, kzg: str):
    """Serialization pick of a derefs field by the ``pcs`` context."""
    def pick(ctx):
        if ctx.get("pcs", "hyrax") == "hyrax":
            return hyrax
        from spartan_tpu_torch.pcs import kzg as KZG

        return getattr(KZG, kzg)
    return pick


@dataclass
class DerefsCommitment:
    comm_ops_val: object  # PolyCommitment (Hyrax) or KZGPolyCommitment

    SCHEMA = {"comm_ops_val": _derefs_spec(PolyCommitment, "KZGPolyCommitment")}

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(b"derefs_commitment", b"begin_derefs_commitment")
        self.comm_ops_val.append_to_transcript(label, transcript)
        transcript.append_message(b"derefs_commitment", b"end_derefs_commitment")


def _n_to_one_reduction(evals: list[int], transcript, label_challenge: bytes):
    """Bind the per-instance claims to one joint claim by bottom-variable
    folds (sparse_mlpoly_full.rs:382-397). Returns (challenges, claim)."""
    challenges = transcript.challenge_vector(label_challenge, log_2(len(evals)))
    poly_evals = DensePolynomial.from_ints(evals)
    for c in reversed(challenges):
        poly_evals.bound_poly_var_bot(c)
    assert poly_evals.len == 1
    return challenges, poly_evals.first()


@dataclass
class DerefsEvalProof:
    """Joint opening of all deref MLEs at rand_ops (Hyrax:
    sparse_mlpoly_full.rs:362-482; KZG: :498-596)."""

    proof_derefs: object  # PolyEvalProof (Hyrax) or KZGPolyEvalProof

    SCHEMA = {"proof_derefs": _derefs_spec(PolyEvalProof, "KZGPolyEvalProof")}

    PROTOCOL = b"Derefs evaluation proof"
    PROTOCOL_KZG = b"Derefs evaluation proof (KZG)"

    @staticmethod
    def _joint_claim(evals: list[int], r: list[int], gens, transcript):
        """Hyrax and KZG bind distinct protocol names (:371 vs :500)."""
        transcript.append_protocol_name(
            DerefsEvalProof.PROTOCOL if isinstance(gens, PolyCommitmentGens)
            else DerefsEvalProof.PROTOCOL_KZG)
        evals = list(evals) + [0] * (next_power_of_two(len(evals)) - len(evals))
        transcript.append_scalars(b"evals_ops_val", evals)
        challenges, joint_claim_eval = _n_to_one_reduction(
            evals, transcript, b"challenge_combine_n_to_one")
        transcript.append_scalar(b"joint_claim_eval", joint_claim_eval)
        return challenges + list(r), joint_claim_eval

    @staticmethod
    def prove(derefs: Derefs, eval_row_ops_val: list[int], eval_col_ops_val: list[int],
              r: list[int], gens, transcript, random_tape, mesh=None) -> "DerefsEvalProof":
        r_joint, joint_claim_eval = DerefsEvalProof._joint_claim(
            list(eval_row_ops_val) + list(eval_col_ops_val), r, gens, transcript)
        if isinstance(gens, PolyCommitmentGens):
            proof, _ = PolyEvalProof.prove(derefs.comb(), None, r_joint, joint_claim_eval,
                                           None, gens, transcript, random_tape, mesh=mesh)
        else:
            proof = gens.prove_eval(derefs.comb(), r_joint, joint_claim_eval, transcript,
                                    mesh=mesh)
        return DerefsEvalProof(proof)

    def verify(self, r: list[int], eval_row_ops_val: list[int], eval_col_ops_val: list[int],
               gens, comm: DerefsCommitment, transcript) -> None:
        r_joint, joint_claim_eval = DerefsEvalProof._joint_claim(
            list(eval_row_ops_val) + list(eval_col_ops_val), r, gens, transcript)
        if isinstance(gens, PolyCommitmentGens):
            self.proof_derefs.verify_plain(gens, transcript, r_joint, joint_claim_eval,
                                           comm.comm_ops_val)
        else:
            gens.verify_eval(self.proof_derefs, comm.comm_ops_val, r_joint,
                             joint_claim_eval, transcript)


# ---------------------------------------------------------------------------
# hash + product layers
# ---------------------------------------------------------------------------

class ProductLayer:
    def __init__(self, init: ProductCircuit, read_vec, write_vec, audit: ProductCircuit):
        self.init = init
        self.read_vec = read_vec
        self.write_vec = write_vec
        self.audit = audit


class Layers:
    """Hash layer + product circuits (sparse_mlpoly_full.rs:744-841)."""

    def __init__(self, eval_table_dev, at: AddrTimestamps,
                 poly_ops_val: list[DensePolynomial], r_mem_check: tuple[int, int],
                 mesh=None):
        r_hash, r_multiset_check = r_mem_check
        dev = eval_table_dev.device
        rh, rh2, gam = F.encode_fr([r_hash, r_hash * r_hash % FR_MOD, r_multiset_check],
                                   device=dev)
        num_mem_cells = eval_table_dev.shape[0]
        ident = F.encode_small_uints(np.arange(num_mem_cells, dtype=np.int64), device=dev)

        def circuit(leaves):
            return ProductCircuit(DensePolynomial(leaves), mesh=mesh)

        init = circuit(k_hash_layer(ident, eval_table_dev, fr.zeros((num_mem_cells,), dev),
                                    rh, rh2, gam))
        audit = circuit(k_hash_layer(ident, eval_table_dev, at.audit_ts().Z, rh, rh2, gam))
        one = fr.one((), dev)
        read_vec, write_vec = [], []
        for a, t, d in zip(at.ops_addr(), at.read_ts(), poly_ops_val):
            read_vec.append(circuit(k_hash_layer(a.Z, d.Z, t.Z, rh, rh2, gam)))
            write_vec.append(circuit(k_hash_layer(a.Z, d.Z, fr.add(t.Z, one), rh, rh2, gam)))
        self.prod_layer = ProductLayer(init, read_vec, write_vec, audit)


class PolyEvalNetwork:
    def __init__(self, dense: MultiSparseMatPolynomialAsDense, derefs: Derefs,
                 mem_rx_dev, mem_ry_dev, r_mem_check: tuple[int, int], mesh=None):
        self.row_layers = Layers(mem_rx_dev, dense.row, derefs.row_ops_val, r_mem_check,
                                 mesh=mesh)
        self.col_layers = Layers(mem_ry_dev, dense.col, derefs.col_ops_val, r_mem_check,
                                 mesh=mesh)


def _joint_opening_claim(evals: list[int], rand: list[int], transcript, label: bytes,
                         label_challenge: bytes, label_joint: bytes):
    """Append the claims, fold them n-to-1, append the joint claim."""
    transcript.append_scalars(label, evals)
    challenges, joint = _n_to_one_reduction(evals, transcript, label_challenge)
    transcript.append_scalar(label_joint, joint)
    return challenges + list(rand), joint


@dataclass
class HashLayerProof:
    """Openings of all hash-layer inputs at (rand_mem, rand_ops)
    (sparse_mlpoly_full.rs:872-1266)."""

    eval_row: tuple  # (addr_vec, read_ts_vec, audit_ts)
    eval_col: tuple
    eval_val: list[int]
    eval_derefs: tuple  # (row_ops_val, col_ops_val)
    proof_ops: PolyEvalProof
    proof_mem: PolyEvalProof
    proof_derefs: DerefsEvalProof

    _VI = ("vec", "int")
    SCHEMA = {
        "eval_row": ("tuple", _VI, _VI, "int"),
        "eval_col": ("tuple", _VI, _VI, "int"),
        "eval_derefs": ("tuple", _VI, _VI),
    }

    PROTOCOL = b"Sparse polynomial hash layer proof"

    @staticmethod
    def prove(rand: tuple[list[int], list[int]], dense: MultiSparseMatPolynomialAsDense,
              derefs: Derefs, gens: SparseMatPolyCommitmentGens, transcript, random_tape,
              mesh=None):
        transcript.append_protocol_name(HashLayerProof.PROTOCOL)
        rand_mem, rand_ops = rand

        with Timer("hash_layer_batch_evals"):
            eval_row_ops_val = batch_evaluate(derefs.row_ops_val, rand_ops)
            eval_col_ops_val = batch_evaluate(derefs.col_ops_val, rand_ops)
        with Timer("derefs_eval_proof"):
            proof_derefs = DerefsEvalProof.prove(
                derefs, eval_row_ops_val, eval_col_ops_val, rand_ops,
                gens.gens_derefs, transcript, random_tape, mesh=mesh)

        # all ops-sized openings share one eq table
        with Timer("ops_addr_ts_evals"):
            ops_evals = batch_evaluate(
                dense.row.ops_addr() + dense.row.read_ts() +
                dense.col.ops_addr() + dense.col.read_ts() + dense.val, rand_ops)
        k = dense.batch_size
        eval_row_addr, eval_row_read_ts = ops_evals[0:k], ops_evals[k:2 * k]
        eval_col_addr, eval_col_read_ts = ops_evals[2 * k:3 * k], ops_evals[3 * k:4 * k]
        eval_val = ops_evals[4 * k:5 * k]
        eval_row_audit_ts, eval_col_audit_ts = batch_evaluate(
            [dense.row.audit_ts(), dense.col.audit_ts()], rand_mem)

        evals_ops = list(ops_evals) + [0] * (next_power_of_two(len(ops_evals)) - len(ops_evals))
        r_joint_ops, joint_claim_eval_ops = _joint_opening_claim(
            evals_ops, rand_ops, transcript, b"claim_evals_ops",
            b"challenge_combine_n_to_one", b"joint_claim_eval_ops")
        with Timer("comb_ops_open"):
            proof_ops, _ = PolyEvalProof.prove(
                dense.comb_ops(), None, r_joint_ops, joint_claim_eval_ops, None,
                gens.gens_ops, transcript, random_tape, mesh=mesh)

        r_joint_mem, joint_claim_eval_mem = _joint_opening_claim(
            [eval_row_audit_ts, eval_col_audit_ts], rand_mem, transcript, b"claim_evals_mem",
            b"challenge_combine_two_to_one", b"joint_claim_eval_mem")
        with Timer("comb_mem_open"):
            proof_mem, _ = PolyEvalProof.prove(
                dense.comb_mem(), None, r_joint_mem, joint_claim_eval_mem, None,
                gens.gens_mem, transcript, random_tape, mesh=mesh)

        return HashLayerProof(
            eval_row=(eval_row_addr, eval_row_read_ts, eval_row_audit_ts),
            eval_col=(eval_col_addr, eval_col_read_ts, eval_col_audit_ts),
            eval_val=eval_val,
            eval_derefs=(eval_row_ops_val, eval_col_ops_val),
            proof_ops=proof_ops,
            proof_mem=proof_mem,
            proof_derefs=proof_derefs,
        )

    @staticmethod
    def _verify_helper(rand, claims, eval_ops_val, eval_ops_addr, eval_read_ts,
                       eval_audit_ts, r, r_hash, r_multiset_check):
        """Re-derive the hashes from the openings (sparse_mlpoly_full.rs:1048-1112)."""
        r_hash_sqr = r_hash * r_hash % FR_MOD

        def hash_func(addr, val, ts):
            return (ts * r_hash_sqr + val * r_hash + addr - r_multiset_check) % FR_MOD

        rand_mem, _rand_ops = rand
        claim_init, claim_read, claim_write, claim_audit = claims

        eval_init_addr = IdentityPolynomial(len(rand_mem)).evaluate(rand_mem)
        eval_init_val = EqPolynomial(r).evaluate(rand_mem)
        h_init = hash_func(eval_init_addr, eval_init_val, 0)
        if claim_init != h_init:
            raise ProofVerifyError(
                "hash layer: init claim mismatch: " + fmt_claims(
                    expected=h_init, got=claim_init,
                    init_addr=eval_init_addr, init_val=eval_init_val))
        h_audit = hash_func(eval_init_addr, eval_init_val, eval_audit_ts)
        if claim_audit != h_audit:
            raise ProofVerifyError(
                "hash layer: audit claim mismatch: " + fmt_claims(
                    expected=h_audit, got=claim_audit, audit_ts=eval_audit_ts))
        for i in range(len(eval_ops_val)):
            hr = hash_func(eval_ops_addr[i], eval_ops_val[i], eval_read_ts[i])
            if claim_read[i] != hr:
                raise ProofVerifyError(
                    f"hash layer: read claim {i} mismatch: " + fmt_claims(
                        expected=hr, got=claim_read[i], addr=eval_ops_addr[i],
                        val=eval_ops_val[i], read_ts=eval_read_ts[i]))
            wts = (eval_read_ts[i] + 1) % FR_MOD
            hw = hash_func(eval_ops_addr[i], eval_ops_val[i], wts)
            if claim_write[i] != hw:
                raise ProofVerifyError(
                    f"hash layer: write claim {i} mismatch: " + fmt_claims(
                        expected=hw, got=claim_write[i], addr=eval_ops_addr[i],
                        val=eval_ops_val[i], write_ts=wts))

    def verify(self, rand, claims_row, claims_col, claims_dotp,
               comm: SparseMatPolyCommitment, comm_derefs: DerefsCommitment,
               gens: SparseMatPolyCommitmentGens, rx, ry,
               r_hash: int, r_multiset_check: int, transcript) -> None:
        transcript.append_protocol_name(HashLayerProof.PROTOCOL)
        rand_mem, rand_ops = rand
        eval_row_ops_val, eval_col_ops_val = self.eval_derefs

        self.proof_derefs.verify(rand_ops, eval_row_ops_val, eval_col_ops_val,
                                 gens.gens_derefs, comm_derefs, transcript)

        eval_row_addr, eval_row_read_ts, eval_row_audit_ts = self.eval_row
        eval_col_addr, eval_col_read_ts, eval_col_audit_ts = self.eval_col

        HashLayerProof._verify_helper(
            (rand_mem, rand_ops), claims_row, eval_row_ops_val,
            eval_row_addr, eval_row_read_ts, eval_row_audit_ts,
            rx, r_hash, r_multiset_check)
        HashLayerProof._verify_helper(
            (rand_mem, rand_ops), claims_col, eval_col_ops_val,
            eval_col_addr, eval_col_read_ts, eval_col_audit_ts,
            ry, r_hash, r_multiset_check)

        # the dotp claims must match the deref and val openings
        num_instances = len(eval_row_ops_val)
        assert len(claims_dotp) == 3 * num_instances
        for i in range(num_instances):
            if claims_dotp[3 * i] != eval_row_ops_val[i]:
                raise ProofVerifyError(f"hash layer: dotp left claim {i} mismatch")
            if claims_dotp[3 * i + 1] != eval_col_ops_val[i]:
                raise ProofVerifyError(f"hash layer: dotp right claim {i} mismatch")
            if claims_dotp[3 * i + 2] != self.eval_val[i]:
                raise ProofVerifyError(f"hash layer: dotp weight claim {i} mismatch")

        evals_ops = (list(eval_row_addr) + list(eval_row_read_ts) +
                     list(eval_col_addr) + list(eval_col_read_ts) + list(self.eval_val))
        evals_ops += [0] * (next_power_of_two(len(evals_ops)) - len(evals_ops))
        r_joint_ops, joint_claim_eval_ops = _joint_opening_claim(
            evals_ops, rand_ops, transcript, b"claim_evals_ops",
            b"challenge_combine_n_to_one", b"joint_claim_eval_ops")
        self.proof_ops.verify_plain(gens.gens_ops, transcript, r_joint_ops,
                                    joint_claim_eval_ops, comm.comm_comb_ops)

        r_joint_mem, joint_claim_eval_mem = _joint_opening_claim(
            [eval_row_audit_ts, eval_col_audit_ts], rand_mem, transcript, b"claim_evals_mem",
            b"challenge_combine_two_to_one", b"joint_claim_eval_mem")
        self.proof_mem.verify_plain(gens.gens_mem, transcript, r_joint_mem,
                                    joint_claim_eval_mem, comm.comm_comb_mem)


def _multiset_claims(prefix: str, init: int, read: list[int], write: list[int], audit: int,
                     transcript) -> None:
    """Append one side's grand-product claims (the caller has checked
    init * prod(write) == prod(read) * audit)."""
    transcript.append_scalar(f"claim_{prefix}_eval_init".encode(), init)
    transcript.append_scalars(f"claim_{prefix}_eval_read".encode(), read)
    transcript.append_scalars(f"claim_{prefix}_eval_write".encode(), write)
    transcript.append_scalar(f"claim_{prefix}_eval_audit".encode(), audit)


def _multiset_holds(init: int, read: list[int], write: list[int], audit: int) -> bool:
    ws = rs = 1
    for v in write:
        ws = ws * v % FR_MOD
    for v in read:
        rs = rs * v % FR_MOD
    return init * ws % FR_MOD == rs * audit % FR_MOD


@dataclass
class ProductLayerProof:
    """Grand-product claims + batched layered sumchecks
    (sparse_mlpoly_full.rs:1292-1521)."""

    eval_row: tuple  # (init, read_vec, write_vec, audit)
    eval_col: tuple
    eval_val: tuple  # (dotp_left_vec, dotp_right_vec)
    proof_mem: ProductCircuitEvalProofBatched
    proof_ops: ProductCircuitEvalProofBatched

    _VI = ("vec", "int")
    SCHEMA = {
        "eval_row": ("tuple", "int", _VI, _VI, "int"),
        "eval_col": ("tuple", "int", _VI, _VI, "int"),
        "eval_val": ("tuple", _VI, _VI),
    }

    PROTOCOL = b"Sparse polynomial product layer proof"

    @staticmethod
    def prove(row_prod_layer: ProductLayer, col_prod_layer: ProductLayer,
              dense: MultiSparseMatPolynomialAsDense, derefs: Derefs,
              eval: list[int], transcript, mesh=None):
        transcript.append_protocol_name(ProductLayerProof.PROTOCOL)

        claims = {}
        for prefix, layer in (("row", row_prod_layer), ("col", col_prod_layer)):
            k = len(layer.read_vec)
            vals = batch_circuit_evals([layer.init, layer.audit] + list(layer.read_vec) +
                                       list(layer.write_vec))
            init, audit, read, write = vals[0], vals[1], vals[2:2 + k], vals[2 + k:]
            assert _multiset_holds(init, read, write, audit)
            _multiset_claims(prefix, init, read, write, audit, transcript)
            claims[prefix] = (init, read, write, audit)

        # dotp circuits, interleaved (left_i, right_i) after a half split
        assert len(eval) == len(derefs.row_ops_val)
        dotp_circuits: list[DotProductCircuit] = []
        for i in range(len(derefs.row_ops_val)):
            circuit = DotProductCircuit(derefs.row_ops_val[i].clone(),
                                        derefs.col_ops_val[i].clone(), dense.val[i].clone())
            dotp_circuits.extend(circuit.split())
        dotp_vals = batch_dotp_evals(dotp_circuits)
        eval_dotp_left_vec, eval_dotp_right_vec = [], []
        for i in range(len(derefs.row_ops_val)):
            el, er = dotp_vals[2 * i], dotp_vals[2 * i + 1]
            transcript.append_scalar(b"claim_eval_dotp_left", el)
            transcript.append_scalar(b"claim_eval_dotp_right", er)
            assert (el + er) % FR_MOD == eval[i] % FR_MOD
            eval_dotp_left_vec.append(el)
            eval_dotp_right_vec.append(er)

        ops_circuits = (list(row_prod_layer.read_vec) + list(row_prod_layer.write_vec) +
                        list(col_prod_layer.read_vec) + list(col_prod_layer.write_vec))
        with Timer("ops_product_trees"):
            proof_ops, rand_ops = ProductCircuitEvalProofBatched.prove(
                ops_circuits, dotp_circuits, transcript, mesh=mesh)

        mem_circuits = [row_prod_layer.init, row_prod_layer.audit,
                        col_prod_layer.init, col_prod_layer.audit]
        with Timer("mem_product_trees"):
            proof_mem, rand_mem = ProductCircuitEvalProofBatched.prove(
                mem_circuits, [], transcript, mesh=mesh)

        return (
            ProductLayerProof(
                eval_row=claims["row"], eval_col=claims["col"],
                eval_val=(eval_dotp_left_vec, eval_dotp_right_vec),
                proof_mem=proof_mem, proof_ops=proof_ops),
            rand_mem,
            rand_ops,
        )

    def verify(self, num_ops: int, num_mem_cells: int, evals: list[int], transcript):
        """Returns (claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops)."""
        transcript.append_protocol_name(ProductLayerProof.PROTOCOL)

        num_instances = len(evals)
        for prefix, (init, read, write, audit) in (("row", self.eval_row),
                                                   ("col", self.eval_col)):
            assert len(read) == num_instances and len(write) == num_instances
            if not _multiset_holds(init, read, write, audit):
                raise ProofVerifyError(
                    f"product layer: {prefix} multiset check failed (init*W != R*audit): "
                    + fmt_claims(init=init, audit=audit, read=read, write=write))
            _multiset_claims(prefix, init, read, write, audit, transcript)
        row_eval_init, row_eval_read, row_eval_write, row_eval_audit = self.eval_row
        col_eval_init, col_eval_read, col_eval_write, col_eval_audit = self.eval_col
        eval_dotp_left_vec, eval_dotp_right_vec = self.eval_val

        claims_dotp_circuit: list[int] = []
        for i in range(num_instances):
            if (eval_dotp_left_vec[i] + eval_dotp_right_vec[i]) % FR_MOD != evals[i] % FR_MOD:
                raise ProofVerifyError(
                    f"product layer: dotp split check {i} failed "
                    "(left + right != claimed eval): " + fmt_claims(
                        left=eval_dotp_left_vec[i], right=eval_dotp_right_vec[i],
                        claimed=evals[i] % FR_MOD))
            transcript.append_scalar(b"claim_eval_dotp_left", eval_dotp_left_vec[i])
            transcript.append_scalar(b"claim_eval_dotp_right", eval_dotp_right_vec[i])
            claims_dotp_circuit.extend([eval_dotp_left_vec[i], eval_dotp_right_vec[i]])

        claims_prod_circuit = (list(row_eval_read) + list(row_eval_write) +
                               list(col_eval_read) + list(col_eval_write))
        claims_ops, claims_dotp, rand_ops = self.proof_ops.verify(
            claims_prod_circuit, claims_dotp_circuit, num_ops, transcript)

        claims_prod_mem = [row_eval_init, row_eval_audit, col_eval_init, col_eval_audit]
        claims_mem, _, rand_mem = self.proof_mem.verify(
            claims_prod_mem, [], num_mem_cells, transcript)

        return claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops


@dataclass
class PolyEvalNetworkProof:
    proof_prod_layer: ProductLayerProof
    proof_hash_layer: HashLayerProof

    PROTOCOL = b"Sparse polynomial evaluation proof"

    @staticmethod
    def prove(network: PolyEvalNetwork, dense: MultiSparseMatPolynomialAsDense,
              derefs: Derefs, evals: list[int], gens: SparseMatPolyCommitmentGens,
              transcript, random_tape, mesh=None) -> "PolyEvalNetworkProof":
        transcript.append_protocol_name(PolyEvalNetworkProof.PROTOCOL)
        with Timer("product_layer_proof"):
            proof_prod_layer, rand_mem, rand_ops = ProductLayerProof.prove(
                network.row_layers.prod_layer, network.col_layers.prod_layer,
                dense, derefs, evals, transcript, mesh=mesh)
        with Timer("hash_layer_proof"):
            proof_hash_layer = HashLayerProof.prove(
                (rand_mem, rand_ops), dense, derefs, gens, transcript, random_tape, mesh=mesh)
        return PolyEvalNetworkProof(proof_prod_layer, proof_hash_layer)

    def verify(self, comm: SparseMatPolyCommitment, comm_derefs: DerefsCommitment,
               evals: list[int], gens: SparseMatPolyCommitmentGens,
               rx: list[int], ry: list[int], r_mem_check: tuple[int, int],
               nz: int, transcript) -> None:
        transcript.append_protocol_name(PolyEvalNetworkProof.PROTOCOL)
        num_instances = len(evals)
        r_hash, r_multiset_check = r_mem_check
        num_ops = next_power_of_two(nz)

        with Timer("v_product_layer"):
            claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops = \
                self.proof_prod_layer.verify(num_ops, comm.num_mem_cells, evals, transcript)
        assert len(claims_mem) == 4
        assert len(claims_ops) == 4 * num_instances

        claims_row = (claims_mem[0], claims_ops[:num_instances],
                      claims_ops[num_instances:2 * num_instances], claims_mem[1])
        claims_col = (claims_mem[2], claims_ops[2 * num_instances:3 * num_instances],
                      claims_ops[3 * num_instances:4 * num_instances], claims_mem[3])

        with Timer("v_hash_layer"):
            self.proof_hash_layer.verify(
                (rand_mem, rand_ops), claims_row, claims_col, claims_dotp,
                comm, comm_derefs, gens, rx, ry, r_hash, r_multiset_check, transcript)


def equalize(rx: list[int], ry: list[int]) -> tuple[list[int], list[int]]:
    """Zero-prefix the shorter point (sparse_mlpoly_full.rs:1681-1697)."""
    if len(rx) < len(ry):
        return [0] * (len(ry) - len(rx)) + list(rx), list(ry)
    if len(rx) > len(ry):
        return list(rx), [0] * (len(rx) - len(ry)) + list(ry)
    return list(rx), list(ry)


@dataclass
class SparseMatPolyEvalProof:
    comm_derefs: DerefsCommitment
    poly_eval_network_proof: PolyEvalNetworkProof

    PROTOCOL = b"Sparse polynomial evaluation proof"

    @staticmethod
    def prove(dense: MultiSparseMatPolynomialAsDense, rx: list[int], ry: list[int],
              evals: list[int], gens: SparseMatPolyCommitmentGens,
              transcript, random_tape, mesh=None) -> "SparseMatPolyEvalProof":
        transcript.append_protocol_name(SparseMatPolyEvalProof.PROTOCOL)
        assert len(evals) == dense.batch_size
        dev = dense.row.device

        with Timer("eq_poly_evals"):
            rx_ext, ry_ext = equalize(rx, ry)
            mem_rx = EqPolynomial(rx_ext).evals_device(dev)
            mem_ry = EqPolynomial(ry_ext).evals_device(dev)

        with Timer("derefs_compute"):
            derefs = dense.deref(mem_rx, mem_ry)

        with Timer("derefs_commitment"):
            comm_derefs = derefs.commit(gens.gens_derefs, mesh=mesh)
            comm_derefs.append_to_transcript(b"comm_poly_row_col_ops_val", transcript)

        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        with Timer("network_construction"):
            net = PolyEvalNetwork(dense, derefs, mem_rx, mem_ry,
                                  (r_mem_check[0], r_mem_check[1]), mesh=mesh)
        with Timer("network_proof"):
            network_proof = PolyEvalNetworkProof.prove(
                net, dense, derefs, evals, gens, transcript, random_tape, mesh=mesh)
        return SparseMatPolyEvalProof(comm_derefs, network_proof)

    def verify(self, comm: SparseMatPolyCommitment, rx: list[int], ry: list[int],
               evals: list[int], gens: SparseMatPolyCommitmentGens, transcript) -> None:
        transcript.append_protocol_name(SparseMatPolyEvalProof.PROTOCOL)
        rx_ext, ry_ext = equalize(rx, ry)
        assert pow2(len(rx_ext)) == comm.num_mem_cells

        self.comm_derefs.append_to_transcript(b"comm_poly_row_col_ops_val", transcript)
        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        self.poly_eval_network_proof.verify(
            comm, self.comm_derefs, evals, gens, rx_ext, ry_ext,
            (r_mem_check[0], r_mem_check[1]), comm.num_ops, transcript)
