"""The benchmark's input generators at a small size: the instances are
satisfied, the same seed gives the same inputs, the keyless stand-in has
exactly the counts its configuration states, and its pool of witnesses,
evaluated level by level in limbs, is the plain forward evaluation for an
input of each witness's own."""

from __future__ import annotations

import pytest

from perfbench.gen import keyless_circom as KC
from perfbench.gen import spartan_synthetic as SS
from perfbench.tests import tiny

FR = KC.FR


def _products(mats, z):
    """(A z, B z, C z) row by row."""
    out = []
    for rows, cols, vals in mats:
        acc = {}
        for r, c, v in zip(rows.tolist(), cols.tolist(), vals):
            acc[r] = (acc.get(r, 0) + v * z[c]) % FR
        out.append(acc)
    return out


def _satisfied(mats, z, num_cons) -> bool:
    az, bz, cz = _products(mats, z)
    return all(az.get(i, 0) * bz.get(i, 0) % FR == cz.get(i, 0) for i in range(num_cons))


def _keyless_z(b, j=0):
    """z in Spartan's layout of witness ``j`` of the generator's pool."""
    inputs, privs = b["witnesses"][j]
    return privs + [0] * (b["num_vars"] - len(privs)) + [1] + inputs


@pytest.mark.parametrize("scale", [1, 4])
def test_keyless_counts_as_configured(tmp_path, scale):
    cfg = dict(tiny.KEYLESS, num_constraints=64 * scale, num_private_vars=60 * scale,
               nnz_total=420 * scale, nnz_max=190 * scale)
    b = KC.build(cfg, 3, str(tmp_path))
    c = b["counts"]
    assert c["constraints"] == cfg["num_constraints"]
    assert c["private_vars"] == cfg["num_private_vars"]
    assert sum(c["nnz"]) == cfg["nnz_total"]
    assert c["nnz"][0] == cfg["nnz_max"] == max(c["nnz"])
    assert b["num_cons"] == b["num_vars"] == 64 * scale


def test_keyless_satisfied_and_seeded(tmp_path):
    b1 = KC.build(tiny.KEYLESS, 2**33 + 5, str(tmp_path), 3)
    pool = [b1["witnesses"][j] for j in range(3)]
    assert len({inputs[0] for inputs, _ in pool}) == 3   # an input of each witness's own
    for j in range(3):
        assert _satisfied(b1["matrices"], _keyless_z(b1, j), b1["num_cons"])
    again = KC.build(tiny.KEYLESS, 2**33 + 5, str(tmp_path), 3)
    assert [again["witnesses"][j] for j in range(3)] == pool
    other = KC.build(tiny.KEYLESS, 6, str(tmp_path))
    assert other["witnesses"][0] != pool[0]
    assert other["r1cs_path"] == b1["r1cs_path"]   # one circuit per configuration
    assert _satisfied(other["matrices"], _keyless_z(other), other["num_cons"])
    z = _keyless_z(b1)
    z[3] = (z[3] + 1) % FR
    assert not _satisfied(b1["matrices"], z, b1["num_cons"])


@pytest.mark.parametrize("chunk", [7, 1 << 15])
def test_keyless_pool_is_the_plain_forward_evaluation(chunk):
    cfg = dict(tiny.KEYLESS, num_constraints=300, num_private_vars=290, nnz_total=2000,
               nnz_max=900)
    st = KC.structure(cfg)
    pubs = [KC.public_input(4, 0), 0, 1, FR - 1]
    pool = KC.Pool(pubs, KC.witnesses(st, pubs, chunk=chunk))
    for j, x in enumerate(pubs):
        w = KC.witness(st, x)
        assert pool[j] == ([w[1]], w[2:])


def test_keyless_refuses_what_it_does_not_make(tmp_path):
    with pytest.raises(ValueError):
        KC.build(dict(tiny.KEYLESS, num_public_inputs=2), 1, str(tmp_path))
    with pytest.raises(ValueError):
        KC.build(dict(tiny.KEYLESS, padded={"num_cons": 32, "num_vars": 64,
                                            "nnz_per_matrix": 128}), 1, str(tmp_path))
    KC.build(dict(tiny.KEYLESS, padded={"num_cons": 64, "num_vars": 64,
                                        "nnz_per_matrix": 128}), 1, str(tmp_path))
    with pytest.raises(ValueError):
        SS.build(tiny.SYNTH, 1, None, 2)


def test_keyless_file_reads_back_through_the_port(tmp_path):
    from spartan_tpu_torch.io.r1cs_reader import R1CSFile

    b = KC.build(tiny.KEYLESS, 1, str(tmp_path))
    r = R1CSFile.from_file(b["r1cs_path"])
    assert r.num_constraints == tiny.KEYLESS["num_constraints"]
    assert r.num_private_vars() == tiny.KEYLESS["num_private_vars"]
    got = r.to_sparse_matrices_padded(b["num_vars"])
    for (rows, cols, vals), mat in zip(b["matrices"], got):
        assert list(zip(rows.tolist(), cols.tolist(), vals)) == [tuple(t) for t in mat]


def test_synthetic_satisfied_and_seeded():
    cfg = tiny.SYNTH
    s = SS.build(cfg, 2**32 + 9, None)
    (inputs, vals), = s["witnesses"]
    z = vals + [1] + inputs
    assert _satisfied(s["matrices"], z, cfg["num_cons"])
    again = SS.build(cfg, 2**32 + 9, None)
    assert again["witnesses"] == s["witnesses"]
    assert again["matrices"][2][2] == s["matrices"][2][2]
    assert SS.build(cfg, 10, None)["witnesses"] != s["witnesses"]
    for rows, cols, vals in s["matrices"]:
        assert len(vals) == cfg["num_cons"] and rows.tolist() == list(range(cfg["num_cons"]))
