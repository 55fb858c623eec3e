"""Product-tree (GKR-style) circuits + layered batched sumcheck proofs.

Counterpart of ``spartan_tpu/core/product_tree.py`` (reference
product_tree.rs). A product circuit keeps every layer's
left/right tables as device tensors; each tree layer is one H1 field
multiply of the layer below's halves. The layered proof joins all
circuits' claims per layer with random coefficients and runs one batched
cubic sumcheck per layer (product_tree.rs:251-392), whose rounds are the
fused S1/S2 kernels; dot-product circuits join only at the leaf layer. A
layer's tables are handed to its sumcheck and dropped from the circuit,
so they are freed as they are folded. With ``mesh`` a large tree is built
on the ranks' strided shards (each level one H1 multiply a rank, no
communication), keeps those layers sharded and gathers one only when its
proof asks for it; the layered sumchecks shard their tables again.

Transcript labels and claim orders match the reference byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core.mle import DensePolynomial, EqPolynomial
from spartan_tpu_torch.core.sumcheck import SumcheckInstanceProof
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.errors import ProofVerifyError, fmt_claims
from spartan_tpu_torch.utils.math import log_2
from spartan_tpu_torch.utils.timer import Timer

fr = F.fr


def batch_circuit_evals(circuits: list["ProductCircuit"]) -> list[int]:
    """All root products, decoded in one device-to-host copy."""
    tops = []
    for c in circuits:
        l, r = c.layer(c.num_layers - 1)
        tops.append(fr.mul(l.Z, r.Z)[0])
    return F.decode_fr(torch.stack(tops, dim=0))


def batch_dotp_evals(circuits: list["DotProductCircuit"]) -> list[int]:
    """All weighted dot products, decoded in one device-to-host copy."""
    outs = [fr.reduce_sum(fr.mul(fr.mul(c.left.Z, c.right.Z), c.weight.Z), axis=0)
            for c in circuits]
    return F.decode_fr(torch.stack(outs, dim=0))


class ProductCircuit:
    """Binary product tree by left/right layer tables (product_tree.rs:15-65).

    With ``mesh``, a tree of more than ``HOST_N`` leaves is built on the
    ranks' strided shards while a level stays above ``HOST_N`` entries and
    divisible by twice the rank count (the JAX package's condition, with
    ``HOST_N`` for its checkpoint size); such layers are kept as shards."""

    def __init__(self, poly: DensePolynomial, mesh=None):
        cur = poly.Z
        n = cur.shape[0]
        self.num_layers = log_2(n)
        self._layers: dict[int, tuple] = {}
        self._mesh = None
        if mesh is not None and mesh.size > 1 and n > HP.HOST_N and \
                n % (2 * mesh.size) == 0:
            from spartan_tpu_torch.parallel.mesh import shard_strided
            from spartan_tpu_torch.parallel.sumcheck_sharded import make_tree_level

            self._mesh = mesh
            cur = shard_strided(mesh, cur)
            m = n
            i = 0
            while m > HP.HOST_N and m % (2 * mesh.size) == 0:
                # a sharded layer: its shard, whose halves are the strided
                # shards of the layer's left and right tables
                self._layers[i] = cur
                cur = make_tree_level(mesh, cur)
                m //= 2
                i += 1
            if i < self.num_layers:
                from spartan_tpu_torch.parallel.mesh import gather_unstride

                self._build(gather_unstride(mesh, cur), i)
        else:
            self._build(cur, 0)

    def _build(self, cur, first: int) -> None:
        for i in range(first, self.num_layers):
            half = cur.shape[0] // 2
            self._layers[i] = (cur[:half], cur[half:2 * half])
            if i + 1 < self.num_layers:
                cur = fr.mul(cur[:half], cur[half:2 * half])

    def layer(self, i: int) -> tuple[DensePolynomial, DensePolynomial]:
        """(left, right) tables of layer ``i`` (0 = leaves), gathered if the
        layer is held sharded."""
        t = self._layers[i]
        if isinstance(t, tuple):
            l, r = t
        else:
            from spartan_tpu_torch.parallel.mesh import gather_unstride

            full = gather_unstride(self._mesh, t)
            half = full.shape[0] // 2
            l, r = full[:half], full[half:]
        return DensePolynomial(l), DensePolynomial(r)

    def release(self, i: int) -> None:
        """Drop layer ``i`` (its proof has taken the tables)."""
        del self._layers[i]

    def layer_len(self, i: int) -> int:
        return 1 << (self.num_layers - 1 - i)

    def evaluate(self) -> int:
        return batch_circuit_evals([self])[0]


class DotProductCircuit:
    """Weighted dot product sum_i L_i R_i W_i (product_tree.rs:68-106)."""

    def __init__(self, left: DensePolynomial, right: DensePolynomial, weight: DensePolynomial):
        assert left.len == right.len == weight.len
        self.left = left
        self.right = right
        self.weight = weight

    def evaluate(self) -> int:
        return batch_dotp_evals([self])[0]

    def split(self):
        idx = self.left.len // 2
        l1, l2 = self.left.split(idx)
        r1, r2 = self.right.split(idx)
        w1, w2 = self.weight.split(idx)
        return DotProductCircuit(l1, r1, w1), DotProductCircuit(l2, r2, w2)


def _eq_host(a_vec: list[int], b_vec: list[int]) -> int:
    eq = 1
    for a, b in zip(a_vec, b_vec):
        eq = eq * ((a * b + (1 - a) * (1 - b)) % FR_MOD) % FR_MOD
    return eq


@dataclass
class LayerProof:
    proof: SumcheckInstanceProof
    claims: list[int]

    def verify(self, claim: int, num_rounds: int, degree_bound: int, transcript):
        return self.proof.verify(claim, num_rounds, degree_bound, transcript)


@dataclass
class ProductCircuitEvalProof:
    """Single-circuit layered proof (product_tree.rs:149-248)."""

    proof: list[LayerProof]

    @staticmethod
    def prove(circuit: ProductCircuit, transcript):
        """Returns (proof, claim, rand). Consumes the circuit's layers."""
        proof: list[LayerProof] = []
        claim = circuit.evaluate()
        dev = circuit.layer(0)[0].Z.device
        rand: list[int] = []
        for layer_id in range(circuit.num_layers - 1, -1, -1):
            poly_C = DensePolynomial(EqPolynomial(rand).evals_device(dev))
            assert poly_C.len == circuit.layer_len(layer_id)
            num_rounds_prod = log_2(poly_C.len) if poly_C.len > 1 else 0
            layer_L, layer_R = circuit.layer(layer_id)
            circuit.release(layer_id)
            proof_prod, rand_prod, claims_prod = SumcheckInstanceProof.prove_cubic(
                claim, num_rounds_prod, layer_L, layer_R, poly_C, transcript)
            transcript.append_scalar(b"claim_prod_left", claims_prod[0])
            transcript.append_scalar(b"claim_prod_right", claims_prod[1])
            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claim = (claims_prod[0] + r_layer * (claims_prod[1] - claims_prod[0])) % FR_MOD
            rand = [r_layer] + rand_prod
            proof.append(LayerProof(proof_prod, claims_prod[:2]))
        return ProductCircuitEvalProof(proof), claim, rand

    def verify(self, eval_: int, length: int, transcript):
        """Returns (claim, rand)."""
        num_layers = log_2(length)
        claim = eval_ % FR_MOD
        rand: list[int] = []
        if len(self.proof) != num_layers:
            raise ProofVerifyError("product tree: wrong number of layers")
        for i in range(num_layers):
            claim_last, rand_prod = self.proof[i].verify(claim, i, 3, transcript)
            claims_prod = self.proof[i].claims
            transcript.append_scalar(b"claim_prod_left", claims_prod[0])
            transcript.append_scalar(b"claim_prod_right", claims_prod[1])
            assert len(rand) == len(rand_prod)
            eq = _eq_host(rand, rand_prod)
            if claims_prod[0] * claims_prod[1] % FR_MOD * eq % FR_MOD != claim_last % FR_MOD:
                raise ProofVerifyError(f"product tree: claim mismatch at layer {i}")
            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claim = ((1 - r_layer) * claims_prod[0] + r_layer * claims_prod[1]) % FR_MOD
            rand = [r_layer] + rand_prod
        return claim, rand


@dataclass
class LayerProofBatched:
    proof: SumcheckInstanceProof
    claims_prod_left: list[int]
    claims_prod_right: list[int]

    def verify(self, claim: int, num_rounds: int, degree_bound: int, transcript):
        return self.proof.verify(claim, num_rounds, degree_bound, transcript)


@dataclass
class ProductCircuitEvalProofBatched:
    proof: list[LayerProofBatched]
    claims_dotp: tuple  # (left, right, weight) final dotp claims

    SCHEMA = {"claims_dotp": ("tuple", ("vec", "int"), ("vec", "int"), ("vec", "int"))}

    @staticmethod
    def prove(prod_circuit_vec: list[ProductCircuit],
              dotp_circuit_vec: list[DotProductCircuit], transcript, mesh=None):
        """Returns (proof, rand) (product_tree.rs:251-392). Consumes the
        circuits' layers and the dotp tables. ``mesh`` shards each layer's
        batched sumcheck."""
        assert prod_circuit_vec
        claims_dotp_final = ([], [], [])
        proof_layers: list[LayerProofBatched] = []
        num_layers = prod_circuit_vec[0].num_layers
        claims_to_verify = batch_circuit_evals(prod_circuit_vec)
        dev = prod_circuit_vec[0].layer(0)[0].Z.device
        rand: list[int] = []

        for layer_id in range(num_layers - 1, -1, -1):
            poly_C_par = DensePolynomial(EqPolynomial(rand).evals_device(dev))
            assert poly_C_par.len == prod_circuit_vec[0].layer_len(layer_id)
            num_rounds_prod = log_2(poly_C_par.len) if poly_C_par.len > 1 else 0
            timer_layer = Timer(
                f"batched_layer[n={poly_C_par.len},K={len(prod_circuit_vec)}]")

            layers = [c.layer(layer_id) for c in prod_circuit_vec]
            for c in prod_circuit_vec:
                c.release(layer_id)
            poly_A_par = [lr[0] for lr in layers]
            poly_B_par = [lr[1] for lr in layers]
            del layers

            poly_A_seq: list[DensePolynomial] = []
            poly_B_seq: list[DensePolynomial] = []
            poly_C_seq: list[DensePolynomial] = []
            if layer_id == 0 and dotp_circuit_vec:
                claims_to_verify = claims_to_verify + batch_dotp_evals(dotp_circuit_vec)
                for d in dotp_circuit_vec:
                    assert d.left.len == poly_C_par.len
                    poly_A_seq.append(d.left)
                    poly_B_seq.append(d.right)
                    poly_C_seq.append(d.weight)

            coeff_vec = transcript.challenge_vector(
                b"rand_coeffs_next_layer", len(claims_to_verify))
            claim = sum(c * w for c, w in zip(claims_to_verify, coeff_vec)) % FR_MOD

            proof, rand_prod, claims_prod, claims_dotp = \
                SumcheckInstanceProof.prove_cubic_batched(
                    claim, num_rounds_prod,
                    (poly_A_par, poly_B_par, poly_C_par),
                    (poly_A_seq, poly_B_seq, poly_C_seq),
                    coeff_vec, transcript, mesh=mesh)
            claims_prod_left, claims_prod_right, _claims_eq = claims_prod

            for i in range(len(prod_circuit_vec)):
                transcript.append_scalar(b"claim_prod_left", claims_prod_left[i])
                transcript.append_scalar(b"claim_prod_right", claims_prod_right[i])

            if layer_id == 0 and dotp_circuit_vec:
                dl, dr, dw = claims_dotp
                for i in range(len(dotp_circuit_vec)):
                    transcript.append_scalar(b"claim_dotp_left", dl[i])
                    transcript.append_scalar(b"claim_dotp_right", dr[i])
                    transcript.append_scalar(b"claim_dotp_weight", dw[i])
                claims_dotp_final = (dl, dr, dw)

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                (claims_prod_left[i] + r_layer * (claims_prod_right[i] - claims_prod_left[i]))
                % FR_MOD for i in range(len(prod_circuit_vec))]
            rand = [r_layer] + rand_prod
            proof_layers.append(LayerProofBatched(proof, claims_prod_left, claims_prod_right))
            timer_layer.stop()

        return ProductCircuitEvalProofBatched(proof_layers, claims_dotp_final), rand

    def verify(self, claims_prod_vec: list[int], claims_dotp_vec: list[int],
               length: int, transcript):
        """Returns (claims, claims_dotp, rand) (product_tree.rs:394-537)."""
        num_layers = log_2(length)
        rand: list[int] = []
        if len(self.proof) != num_layers:
            raise ProofVerifyError("product tree: wrong number of layers")

        claims_to_verify = list(claims_prod_vec)
        claims_to_verify_dotp: list[int] = []

        for i in range(num_layers):
            if i == num_layers - 1:
                claims_to_verify = claims_to_verify + list(claims_dotp_vec)

            coeff_vec = transcript.challenge_vector(
                b"rand_coeffs_next_layer", len(claims_to_verify))
            claim = sum(c * w for c, w in zip(claims_to_verify, coeff_vec)) % FR_MOD

            claim_last, rand_prod = self.proof[i].verify(claim, i, 3, transcript)

            claims_prod_left = self.proof[i].claims_prod_left
            claims_prod_right = self.proof[i].claims_prod_right
            if len(claims_prod_left) != len(claims_prod_vec) or \
               len(claims_prod_right) != len(claims_prod_vec):
                raise ProofVerifyError("product tree: claim count mismatch")

            for j in range(len(claims_prod_vec)):
                transcript.append_scalar(b"claim_prod_left", claims_prod_left[j])
                transcript.append_scalar(b"claim_prod_right", claims_prod_right[j])

            assert len(rand) == len(rand_prod)
            eq = _eq_host(rand, rand_prod)
            claim_expected = sum(
                coeff_vec[j] * claims_prod_left[j] % FR_MOD * claims_prod_right[j] % FR_MOD * eq
                for j in range(len(claims_prod_vec))) % FR_MOD

            if i == num_layers - 1:
                num_prod = len(claims_prod_vec)
                dl, dr, dw = self.claims_dotp
                for k in range(len(dl)):
                    transcript.append_scalar(b"claim_dotp_left", dl[k])
                    transcript.append_scalar(b"claim_dotp_right", dr[k])
                    transcript.append_scalar(b"claim_dotp_weight", dw[k])
                    claim_expected = (
                        claim_expected + coeff_vec[k + num_prod] * dl[k] * dr[k] * dw[k]
                    ) % FR_MOD

            if claim_expected != claim_last % FR_MOD:
                raise ProofVerifyError(
                    f"product tree: claim mismatch at layer {i} "
                    f"({len(claims_prod_vec)} prod instances"
                    f"{', +dotp leaf layer' if i == num_layers - 1 else ''}): "
                    + fmt_claims(expected=claim_expected, got=claim_last % FR_MOD,
                                 claims_left=claims_prod_left,
                                 claims_right=claims_prod_right, coeffs=coeff_vec))

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                (claims_prod_left[j] + r_layer * (claims_prod_right[j] - claims_prod_left[j]))
                % FR_MOD for j in range(len(claims_prod_left))]
            if i == num_layers - 1:
                dl, dr, dw = self.claims_dotp
                for k in range(len(claims_dotp_vec) // 2):
                    claims_to_verify_dotp.append(
                        (dl[2 * k] + r_layer * (dl[2 * k + 1] - dl[2 * k])) % FR_MOD)
                    claims_to_verify_dotp.append(
                        (dr[2 * k] + r_layer * (dr[2 * k + 1] - dr[2 * k])) % FR_MOD)
                    claims_to_verify_dotp.append(
                        (dw[2 * k] + r_layer * (dw[2 * k + 1] - dw[2 * k])) % FR_MOD)

            rand = [r_layer] + rand_prod

        return claims_to_verify, claims_to_verify_dotp, rand
