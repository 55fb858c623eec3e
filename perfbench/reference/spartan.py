"""A plain verifier of Spartan's NIZK and SNARK proofs over BN254.

It follows the protocol of Spartan-BN254 (microsoft/Spartan with the
Antiparadox BN254 changes): the zero-knowledge sumchecks of the R1CS proof
with their sigma proofs, the Hyrax openings by the log-size dot-product
proof, and in the SNARK the lookup argument's product and hash layers with
the derefs opened under Hyrax or KZG.

Spartan derives its Pedersen generators as ``s * G`` with ``s`` a hash of
the label, so the discrete log of every generator is public. This
verifier uses that: a commitment over the generators is ``(sum v_i s_i +
b s_h) * G``, one multiplication of ``G``, and the matrix commitment of
the SNARK is recomputed row by row from the matrices (``Matrices``). The
KZG test SRS comes from a public seed, so ``tau`` is known too and the
pairing check ``e(C - y G, G2) = e(pi, (tau - z) G2)`` becomes
``C - y G = (tau - z) pi``. The port's KZG protocol never ties the derefs
it commits to the claims of the lookup argument, so under KZG the
verifier also works the derefs out from the matrices at (rx, ry) and
holds the commitment to them at ``tau`` and the opened value at ``z``. Only points the prover chose (blinded
commitments, the derefs, the bullet rounds) go through real
multi-scalar multiplications.

``verify_nizk`` and ``verify_snark`` raise ``Reject`` with the failed
check's name, and return nothing when the proof is valid.
"""

from __future__ import annotations

import hashlib

from perfbench.reference import bn254 as C
from perfbench.reference.bn254 import FR
from perfbench.reference.transcript import Transcript

class Reject(Exception):
    """The proof fails a check of the verifier."""


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise Reject(what)


# -- field helpers ---------------------------------------------------------------

def eq_table(r: list[int]) -> list[int]:
    """eq(r, i) for every i, r[0] the most significant bit of i."""
    table = [1]
    for rj in r:
        nxt = []
        for t in table:
            h = t * rj % FR
            nxt.append((t - h) % FR)
            nxt.append(h)
        table = nxt
    return table


def eq_eval(a: list[int], b: list[int]) -> int:
    acc = 1
    for x, y in zip(a, b, strict=True):
        acc = acc * (x * y + (1 - x) * (1 - y)) % FR
    return acc


def dot(a, b) -> int:
    return sum(x * y for x, y in zip(a, b, strict=True)) % FR


def pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def log2(n: int) -> int:
    return n.bit_length() - 1


# -- generators ----------------------------------------------------------------------

def gen_dlogs(label: bytes, count: int) -> list[int]:
    """The discrete logs of the first ``count`` generators of ``label``:
    SHAKE256(label || compressed G) read 64 bytes at a time, each hashed by
    SHA3-256 to a scalar, with Spartan's fallback for hashes not below the
    modulus."""
    shake = hashlib.shake_256()
    shake.update(label)
    shake.update(C.compress(C.to_jac(C.GEN)))
    stream = shake.digest(64 * count)
    out = []
    for i in range(count):
        uniform = stream[64 * i:64 * i + 64]
        v = int.from_bytes(hashlib.sha3_256(uniform).digest(), "little")
        if v >= FR:
            v = int.from_bytes(hashlib.sha3_256(b"fallback" + uniform).digest(), "little")
            v = v if v < FR else 1
        out.append(v)
    return out


class Gens:
    """``n`` generators and the blinding one, as discrete logs."""

    def __init__(self, G: list[int], h: int):
        self.G, self.h = G, h

    @staticmethod
    def new(label: bytes, n: int) -> "Gens":
        s = gen_dlogs(label, n + 1)
        return Gens(s[:n], s[n])

    def commit(self, values: list[int], blind: int):
        return C.gmul(dot(values, self.G) + blind * self.h)


class DotGens:
    """Spartan's DotProductProofGens: ``n`` generators plus one, one ``h``."""

    def __init__(self, label: bytes, n: int):
        s = gen_dlogs(label, n + 2)
        self.n = n
        self.gens_n = Gens(s[:n], s[n + 1])
        self.gens_1 = Gens([s[n]], s[n + 1])


def poly_gens(label: bytes, num_vars: int) -> DotGens:
    return DotGens(label, 1 << (num_vars - num_vars // 2))


# -- point helpers ------------------------------------------------------------------

def _append(t: Transcript, label: bytes, p) -> None:
    t.append_point(label, C.compress(p))


def _lin(*terms):
    """sum of k * P over (k, P) terms, P Jacobian points."""
    acc = None
    for k, p in terms:
        acc = C.jadd(acc, C.jmul(k, p))
    return acc


def _msm_jac(scalars: list[int], points: list):
    return C.msm(scalars, [C.to_affine(p) for p in points])


def _append_poly_commitment(t: Transcript, label: bytes, rows: list) -> None:
    t.append_message(label, b"poly_commitment_begin")
    for p in rows:
        _append(t, b"poly_commitment_share", p)
    t.append_message(label, b"poly_commitment_end")


# -- sigma proofs ---------------------------------------------------------------------

def _dot_product(pf: dict, g1: Gens, gn: Gens, t: Transcript, a: list[int], Cx, Cy) -> None:
    _check(len(pf["z"]) == len(a) == len(gn.G), "dot product proof: length")
    t.append_protocol_name(b"dot product proof")
    _append(t, b"Cx", Cx)
    _append(t, b"Cy", Cy)
    t.append_scalars(b"a", a)
    _append(t, b"delta", pf["delta"])
    _append(t, b"beta", pf["beta"])
    c = t.challenge_scalar(b"c")
    _check(C.jeq(C.jadd(C.jmul(c, Cx), pf["delta"]), gn.commit(pf["z"], pf["z_delta"])),
           "dot product proof: Cx")
    _check(C.jeq(C.jadd(C.jmul(c, Cy), pf["beta"]),
                 g1.commit([dot(pf["z"], a)], pf["z_beta"])), "dot product proof: Cy")


def _equality(pf: dict, g1: Gens, t: Transcript, C1, C2) -> None:
    t.append_protocol_name(b"equality proof")
    _append(t, b"C1", C1)
    _append(t, b"C2", C2)
    _append(t, b"alpha", pf["alpha"])
    c = t.challenge_scalar(b"c")
    rhs = C.jadd(C.jmul(c, C.jadd(C1, C.jneg(C2))), pf["alpha"])
    _check(C.jeq(C.gmul(pf["z"] * g1.h), rhs), "equality proof")


def _knowledge(pf: dict, g1: Gens, t: Transcript, Cm) -> None:
    t.append_protocol_name(b"knowledge proof")
    _append(t, b"C", Cm)
    _append(t, b"alpha", pf["alpha"])
    c = t.challenge_scalar(b"c")
    _check(C.jeq(g1.commit([pf["z1"]], pf["z2"]), C.jadd(C.jmul(c, Cm), pf["alpha"])),
           "knowledge proof")


def _product(pf: dict, g1: Gens, t: Transcript, X, Y, Z) -> None:
    t.append_protocol_name(b"product proof")
    for label, p in ((b"X", X), (b"Y", Y), (b"Z", Z), (b"alpha", pf["alpha"]),
                     (b"beta", pf["beta"]), (b"delta", pf["delta"])):
        _append(t, label, p)
    _check(len(pf["z"]) == 5, "product proof: length")
    z1, z2, z3, z4, z5 = pf["z"]
    c = t.challenge_scalar(b"c")
    _check(C.jeq(C.jadd(pf["alpha"], C.jmul(c, X)), g1.commit([z1], z2)), "product proof: X")
    _check(C.jeq(C.jadd(pf["beta"], C.jmul(c, Y)), g1.commit([z3], z4)), "product proof: Y")
    _check(C.jeq(C.jadd(pf["delta"], C.jmul(c, Z)),
                 C.jadd(C.jmul(z3, X), C.gmul(z5 * g1.h))), "product proof: Z")


def _dot_product_log(pf: dict, gens: DotGens, t: Transcript, a: list[int], Cx, Cy) -> None:
    n = gens.n
    _check(len(a) == n, "dot product proof (log): length")
    t.append_protocol_name(b"dot product proof (log)")
    _append(t, b"Cx", Cx)
    _append(t, b"Cy", Cy)
    t.append_scalars(b"a", a)
    r = t.challenge_scalar(b"r")
    gamma = C.jadd(Cx, C.jmul(r, Cy))
    # the bullet reduction
    lg = log2(n)
    _check(len(pf["L"]) == lg and len(pf["R"]) == lg, "bullet: rounds")
    u = []
    for L, R in zip(pf["L"], pf["R"]):
        _append(t, b"L", L)
        _append(t, b"R", R)
        u.append(t.challenge_scalar(b"u"))
    _check(all(u), "bullet: zero challenge")
    u_inv = C.batch_inv(u)
    s = [1]
    for ui, uinv in zip(reversed(u), reversed(u_inv)):
        s = [x * uinv % FR for x in s] + [x * ui % FR for x in s]
    u_sq = [x * x % FR for x in u]
    u_sq_inv = [x * x % FR for x in u_inv]
    g_hat = dot(s, gens.gens_n.G)          # discrete log of <s, G>
    a_hat = dot(s, a)
    gamma_hat = C.jadd(_msm_jac(u_sq + u_sq_inv, pf["L"] + pf["R"]), gamma)
    _append(t, b"delta", pf["delta"])
    _append(t, b"beta", pf["beta"])
    c = t.challenge_scalar(b"c")
    q = r * gens.gens_1.G[0] % FR          # the scaled gens_1
    lhs = C.jadd(C.jmul(a_hat, C.jadd(C.jmul(c, gamma_hat), pf["beta"])), pf["delta"])
    rhs = C.gmul((g_hat + q * a_hat) * pf["z1"] + gens.gens_1.h * pf["z2"])
    _check(C.jeq(lhs, rhs), "dot product proof (log)")


def _poly_eval(pf: dict, gens: DotGens, t: Transcript, r: list[int], C_Zr, rows) -> None:
    """A Hyrax opening of the committed table at r; ``rows`` is either the
    row commitments as points or, for a commitment the verifier worked out
    itself, the rows' discrete logs (``("dlogs", [...])``)."""
    t.append_protocol_name(b"polynomial evaluation proof")
    left = len(r) // 2
    L, R = eq_table(r[:left]), eq_table(r[left:])
    if isinstance(rows, tuple) and rows[0] == "dlogs":
        _check(len(rows[1]) == len(L), "polynomial evaluation proof: rows")
        c_lz = C.gmul(dot(L, rows[1]))
    else:
        _check(len(rows) == len(L), "polynomial evaluation proof: rows")
        c_lz = _msm_jac(L, rows)
    _dot_product_log(pf, gens, t, R, c_lz, C_Zr)


# -- sumchecks -------------------------------------------------------------------------

def _zk_sumcheck(pf: dict, comm_claim, rounds: int, degree: int, g1: Gens, gn: Gens,
                 t: Transcript):
    _check(len(pf["comm_polys"]) == rounds and len(pf["comm_evals"]) == rounds
           and len(pf["proofs"]) == rounds, "zk sumcheck: rounds")
    r = []
    claim = comm_claim
    for i in range(rounds):
        _append(t, b"comm_poly", pf["comm_polys"][i])
        ri = t.challenge_scalar(b"challenge_nextround")
        _append(t, b"comm_claim_per_round", claim)
        _append(t, b"comm_eval", pf["comm_evals"][i])
        w = t.challenge_vector(b"combine_two_claims_to_one", 2)
        target = C.jadd(C.jmul(w[0], claim), C.jmul(w[1], pf["comm_evals"][i]))
        a_eval = [1]
        for _ in range(degree):
            a_eval.append(a_eval[-1] * ri % FR)
        a = [(w[0] * (2 if j == 0 else 1) + w[1] * a_eval[j]) % FR for j in range(degree + 1)]
        _dot_product(pf["proofs"][i], g1, gn, t, a, pf["comm_polys"][i], target)
        claim = pf["comm_evals"][i]
        r.append(ri)
    return claim, r


def _sumcheck(polys: list[list[int]], claim: int, rounds: int, degree: int, t: Transcript):
    _check(len(polys) == rounds, "sumcheck: rounds")
    e, r = claim % FR, []
    for cs in polys:
        _check(len(cs) == degree, "sumcheck: degree")
        linear = (e - 2 * cs[0] - sum(cs[1:])) % FR
        coeffs = [cs[0], linear] + cs[1:]
        t.append_message(b"poly", b"UniPoly_begin")
        for c in coeffs:
            t.append_scalar(b"coeff", c)
        t.append_message(b"poly", b"UniPoly_end")
        ri = t.challenge_scalar(b"challenge_nextround")
        r.append(ri)
        e = 0
        for c in reversed(coeffs):
            e = (e * ri + c) % FR
    return e, r


# -- the R1CS proof ------------------------------------------------------------------------

class R1CSGens:
    def __init__(self, num_vars: int):
        label = b"gens_r1cs_sat"
        self.pc = poly_gens(label, log2(num_vars))
        self.g1 = self.pc.gens_1
        self.g3 = Gens.new(label, 3)
        self.g4 = Gens.new(label, 4)


def _input_eval(inputs: list[int], ry_rest: list[int]) -> int:
    ell = len(ry_rest)

    def eq_at(col: int) -> int:
        acc = 1
        for j in range(ell):
            acc = acc * (ry_rest[j] if (col >> (ell - 1 - j)) & 1 else 1 - ry_rest[j]) % FR
        return acc

    return (eq_at(0) + sum(v * eq_at(i + 1) for i, v in enumerate(inputs))) % FR


def verify_r1cs(pf: dict, num_vars: int, num_cons: int, inputs: list[int],
                evals: tuple[int, int, int], t: Transcript, gens: R1CSGens):
    """Returns (rx, ry)."""
    t.append_protocol_name(b"R1CS proof")
    t.append_scalars(b"input", inputs)
    _append_poly_commitment(t, b"poly_commitment", pf["comm_vars"])
    tau = t.challenge_vector(b"challenge_tau", log2(num_cons))
    comm_post1, rx = _zk_sumcheck(pf["sc_phase1"], gens.g1.commit([0], 0), log2(num_cons), 3,
                                  gens.g1, gens.g4, t)
    cAz, cBz, cCz, cProd = pf["claims_phase2"]
    _knowledge(pf["pok"], gens.g1, t, cCz)
    _product(pf["prod"], gens.g1, t, cAz, cBz, cProd)
    for label, p in ((b"comm_Az_claim", cAz), (b"comm_Bz_claim", cBz),
                     (b"comm_Cz_claim", cCz), (b"comm_prod_Az_Bz_claims", cProd)):
        _append(t, label, p)
    expected1 = C.jmul(eq_eval(tau, rx), C.jadd(cProd, C.jneg(cCz)))
    _equality(pf["eq_phase1"], gens.g1, t, expected1, comm_post1)
    rA = t.challenge_scalar(b"challenge_Az")
    rB = t.challenge_scalar(b"challenge_Bz")
    rC = t.challenge_scalar(b"challenge_Cz")
    claim2 = _lin((rA, cAz), (rB, cBz), (rC, cCz))
    comm_post2, ry = _zk_sumcheck(pf["sc_phase2"], claim2, log2(2 * num_vars), 2,
                                  gens.g1, gens.g3, t)
    _poly_eval(pf["eval_vars_at_ry"], gens.pc, t, ry[1:], pf["comm_vars_at_ry"],
               pf["comm_vars"])
    z_at_ry = C.jadd(C.jmul(1 - ry[0], pf["comm_vars_at_ry"]),
                     C.gmul(_input_eval(inputs, ry[1:]) * gens.g1.G[0] % FR * ry[0]))
    scalar = (rA * evals[0] + rB * evals[1] + rC * evals[2]) % FR
    _equality(pf["eq_phase2"], gens.g1, t, C.jmul(scalar, z_at_ry), comm_post2)
    return rx, ry


# -- the NIZK --------------------------------------------------------------------------------

def nizk_prefix(label: bytes, digest: bytes) -> Transcript:
    """The verifier's transcript after the NIZK's protocol name and the
    instance's digest: the same for every proof of one instance."""
    t = Transcript(label)
    t.append_protocol_name(b"Spartan NIZK proof")
    t.append_message(b"R1CSShapeDigest", digest)
    return t


def verify_nizk(pf: dict, prefix: Transcript, inst, inputs: list[int], gens: R1CSGens) -> None:
    """``inst`` has ``num_vars``, ``num_cons`` and ``evaluate(rx, ry)``."""
    t = prefix.copy()
    evals = inst.evaluate(pf["rx"], pf["ry"])
    _check(len(inputs) == inst.num_inputs, "number of inputs")
    rx, ry = verify_r1cs(pf["r1cs"], inst.num_vars, inst.num_cons, inputs, evals, t, gens)
    _check(rx == pf["rx"] and ry == pf["ry"], "NIZK: claimed (rx, ry)")


# -- the lookup argument -------------------------------------------------------------------------

def _n_to_one(evals: list[int], t: Transcript, label: bytes):
    cs = t.challenge_vector(label, log2(len(evals)))
    z = list(evals)
    for c in reversed(cs):
        z = [(z[2 * i] + c * (z[2 * i + 1] - z[2 * i])) % FR for i in range(len(z) // 2)]
    return cs, z[0]


def _batched_tree(pf: dict, claims_prod: list[int], claims_dotp: list[int], length: int,
                  t: Transcript):
    layers = pf["layers"]
    num_layers = log2(length)
    _check(len(layers) == num_layers, "product tree: layers")
    rand: list[int] = []
    to_verify = list(claims_prod)
    to_verify_dotp: list[int] = []
    n_prod = len(claims_prod)
    for i, layer in enumerate(layers):
        last = i == num_layers - 1
        if last:
            to_verify = to_verify + list(claims_dotp)
        coeffs = t.challenge_vector(b"rand_coeffs_next_layer", len(to_verify))
        claim = dot(to_verify, coeffs)
        claim_last, rand_prod = _sumcheck(layer["polys"], claim, i, 3, t)
        left, right = layer["left"], layer["right"]
        _check(len(left) == len(right) == n_prod, "product tree: claims")
        for j in range(n_prod):
            t.append_scalar(b"claim_prod_left", left[j])
            t.append_scalar(b"claim_prod_right", right[j])
        e = eq_eval(rand, rand_prod)
        expected = sum(coeffs[j] * left[j] % FR * right[j] % FR * e for j in range(n_prod)) % FR
        if last:
            dl, dr, dw = pf["claims_dotp"]
            _check(len(dl) == len(dr) == len(dw) == len(claims_dotp),
                   "product tree: dotp claims")
            for k in range(len(dl)):
                t.append_scalar(b"claim_dotp_left", dl[k])
                t.append_scalar(b"claim_dotp_right", dr[k])
                t.append_scalar(b"claim_dotp_weight", dw[k])
                expected = (expected + coeffs[k + n_prod] * dl[k] * dr[k] * dw[k]) % FR
        _check(expected == claim_last, f"product tree: layer {i}")
        r_layer = t.challenge_scalar(b"challenge_r_layer")
        to_verify = [(left[j] + r_layer * (right[j] - left[j])) % FR for j in range(n_prod)]
        if last:
            dl, dr, dw = pf["claims_dotp"]
            for k in range(len(claims_dotp) // 2):
                for v in (dl, dr, dw):
                    to_verify_dotp.append((v[2 * k] + r_layer * (v[2 * k + 1] - v[2 * k])) % FR)
        rand = [r_layer] + rand_prod
    return to_verify, to_verify_dotp, rand


def _product_layer(pf: dict, num_ops: int, num_mem: int, evals: list[int], t: Transcript):
    t.append_protocol_name(b"Sparse polynomial product layer proof")
    n = len(evals)
    for name, key in ((b"row", "eval_row"), (b"col", "eval_col")):
        init, read, write, audit = pf[key]
        _check(len(read) == len(write) == n, "product layer: instances")
        ws = rs = 1
        for v in write:
            ws = ws * v % FR
        for v in read:
            rs = rs * v % FR
        _check(init * ws % FR == rs * audit % FR, f"product layer: {name.decode()} multiset")
        t.append_scalar(b"claim_" + name + b"_eval_init", init)
        t.append_scalars(b"claim_" + name + b"_eval_read", read)
        t.append_scalars(b"claim_" + name + b"_eval_write", write)
        t.append_scalar(b"claim_" + name + b"_eval_audit", audit)
    left, right = pf["eval_val"]
    dotp = []
    for i in range(n):
        _check((left[i] + right[i]) % FR == evals[i] % FR, f"product layer: dotp split {i}")
        t.append_scalar(b"claim_eval_dotp_left", left[i])
        t.append_scalar(b"claim_eval_dotp_right", right[i])
        dotp += [left[i], right[i]]
    r_init, r_read, r_write, r_audit = pf["eval_row"]
    c_init, c_read, c_write, c_audit = pf["eval_col"]
    claims_ops, claims_dotp, rand_ops = _batched_tree(
        pf["proof_ops"], list(r_read) + list(r_write) + list(c_read) + list(c_write), dotp,
        num_ops, t)
    claims_mem, _, rand_mem = _batched_tree(pf["proof_mem"], [r_init, r_audit, c_init, c_audit],
                                            [], num_mem, t)
    return claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops


def _hash_claims(rand_mem, claims, ops_val, ops_addr, read_ts, audit_ts, r, r_hash, gamma,
                 what: str) -> None:
    r2 = r_hash * r_hash % FR

    def h(addr, val, ts):
        return (ts * r2 + val * r_hash + addr - gamma) % FR

    init_addr = sum((1 << (len(rand_mem) - 1 - i)) * x for i, x in enumerate(rand_mem)) % FR
    init_val = eq_eval(r, rand_mem)
    c_init, c_read, c_write, c_audit = claims
    _check(c_init == h(init_addr, init_val, 0), f"hash layer: {what} init")
    _check(c_audit == h(init_addr, init_val, audit_ts), f"hash layer: {what} audit")
    _check(len(ops_val) == len(ops_addr) == len(read_ts) == len(c_read) == len(c_write),
           f"hash layer: {what} instances")
    for i in range(len(ops_val)):
        _check(c_read[i] == h(ops_addr[i], ops_val[i], read_ts[i]), f"hash layer: {what} read {i}")
        _check(c_write[i] == h(ops_addr[i], ops_val[i], read_ts[i] + 1),
               f"hash layer: {what} write {i}")


class EvalGens:
    """The generators of the SNARK's matrix commitment."""

    def __init__(self, num_cons: int, num_vars: int, nnz: int, pcs: str,
                 srs_seed: int | None = None):
        label = b"gens_r1cs_eval"
        nx, ny = log2(num_cons), log2(2 * num_vars)
        nz = log2(pow2_ceil(max(2, nnz)))
        self.ops = poly_gens(label, nz + 4)      # 3 matrices x 5 tables -> 16
        self.mem = poly_gens(label, max(nx, ny) + 1)
        self.pcs = pcs
        if pcs == "hyrax":
            self.derefs = poly_gens(label, nz + 3)   # 3 x 2 derefs -> 8
        else:
            # the test SRS's tau, from the seed the benchmark gave the SRS
            self.tau = int.from_bytes(hashlib.sha256(
                b"spartan_tpu.kzg.tau" + srs_seed.to_bytes(8, "little")).digest(), "little") % FR


def _derefs(pf_hash: dict, comm_derefs, rand_ops, row_vals, col_vals, gens: EvalGens,
            t: Transcript, comm: "Commitment", rx: list[int], ry: list[int]) -> None:
    hyrax = gens.pcs == "hyrax"
    t.append_protocol_name(b"Derefs evaluation proof" if hyrax
                           else b"Derefs evaluation proof (KZG)")
    evals = list(row_vals) + list(col_vals)
    evals += [0] * (pow2_ceil(len(evals)) - len(evals))
    t.append_scalars(b"evals_ops_val", evals)
    cs, joint = _n_to_one(evals, t, b"challenge_combine_n_to_one")
    t.append_scalar(b"joint_claim_eval", joint)
    pf = pf_hash["proof_derefs"]
    if hyrax:
        _poly_eval(pf, gens.derefs, t, cs + list(rand_ops),
                   C.gmul(joint * gens.derefs.gens_1.G[0]), comm_derefs)
        return
    z = t.challenge_scalar(b"kzg_eval_point")
    at_tau, at_z = comm.derefs_at(rx, ry, [gens.tau, z])
    _check(C.jeq(comm_derefs, C.gmul(at_tau)), "KZG derefs commitment")
    _check(pf["eval"] % FR == at_z, "KZG derefs evaluation")
    lhs = C.jadd(comm_derefs, C.jneg(C.gmul(pf["eval"])))
    _check(C.jeq(lhs, C.jmul(gens.tau - z, pf["proof"])), "KZG derefs opening")


def verify_snark(pf: dict, label: bytes, comm: "Commitment", inputs: list[int],
                 r1cs_gens: R1CSGens, gens: EvalGens) -> None:
    t = Transcript(label)
    t.append_protocol_name(b"Spartan SNARK proof")
    comm.append_to_transcript(t)
    _check(len(inputs) == comm.num_inputs, "number of inputs")
    evals = pf["inst_evals"]
    rx, ry = verify_r1cs(pf["r1cs"], comm.num_vars, comm.num_cons, inputs, evals, t, r1cs_gens)

    # the sparse evaluation proof of A, B, C at (rx, ry)
    t.append_protocol_name(b"Sparse polynomial evaluation proof")
    if len(rx) < len(ry):
        rx = [0] * (len(ry) - len(rx)) + rx
    elif len(ry) < len(rx):
        ry = [0] * (len(rx) - len(ry)) + ry
    _check(1 << len(rx) == comm.num_mem_cells, "memory size")
    t.append_message(b"derefs_commitment", b"begin_derefs_commitment")
    if gens.pcs == "hyrax":
        _append_poly_commitment(t, b"comm_poly_row_col_ops_val", pf["comm_derefs"])
    else:
        _append(t, b"comm_poly_row_col_ops_val", pf["comm_derefs"])
    t.append_message(b"derefs_commitment", b"end_derefs_commitment")
    r_hash, gamma = t.challenge_vector(b"challenge_r_hash", 2)
    t.append_protocol_name(b"Sparse polynomial evaluation proof")
    claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops = _product_layer(
        pf["prod"], comm.num_ops, comm.num_mem_cells, list(evals), t)
    n = len(evals)
    _check(len(claims_mem) == 4 and len(claims_ops) == 4 * n, "product layer: claims")
    claims_row = (claims_mem[0], claims_ops[:n], claims_ops[n:2 * n], claims_mem[1])
    claims_col = (claims_mem[2], claims_ops[2 * n:3 * n], claims_ops[3 * n:], claims_mem[3])

    hl = pf["hash"]
    t.append_protocol_name(b"Sparse polynomial hash layer proof")
    row_vals, col_vals = hl["eval_derefs"]
    _derefs(hl, pf["comm_derefs"], rand_ops, row_vals, col_vals, gens, t, comm, rx, ry)
    row_addr, row_read, row_audit = hl["eval_row"]
    col_addr, col_read, col_audit = hl["eval_col"]
    _hash_claims(rand_mem, claims_row, row_vals, row_addr, row_read, row_audit, rx, r_hash,
                 gamma, "row")
    _hash_claims(rand_mem, claims_col, col_vals, col_addr, col_read, col_audit, ry, r_hash,
                 gamma, "col")
    _check(len(claims_dotp) == 3 * n and len(hl["eval_val"]) == n, "hash layer: dotp claims")
    for i in range(n):
        _check(claims_dotp[3 * i] == row_vals[i] and claims_dotp[3 * i + 1] == col_vals[i]
               and claims_dotp[3 * i + 2] == hl["eval_val"][i], f"hash layer: dotp {i}")
    evals_ops = list(row_addr) + list(row_read) + list(col_addr) + list(col_read) + \
        list(hl["eval_val"])
    evals_ops += [0] * (pow2_ceil(len(evals_ops)) - len(evals_ops))
    t.append_scalars(b"claim_evals_ops", evals_ops)
    cs, joint = _n_to_one(evals_ops, t, b"challenge_combine_n_to_one")
    t.append_scalar(b"joint_claim_eval_ops", joint)
    _poly_eval(hl["proof_ops"], gens.ops, t, cs + list(rand_ops),
               C.gmul(joint * gens.ops.gens_1.G[0]), ("dlogs", comm.ops_dlogs))
    evals_mem = [row_audit, col_audit]
    t.append_scalars(b"claim_evals_mem", evals_mem)
    cs, joint = _n_to_one(evals_mem, t, b"challenge_combine_two_to_one")
    t.append_scalar(b"joint_claim_eval_mem", joint)
    _poly_eval(hl["proof_mem"], gens.mem, t, cs + list(rand_mem),
               C.gmul(joint * gens.mem.gens_1.G[0]), ("dlogs", comm.mem_dlogs))
