"""The bullet reduction's prover on each route: every round on the device,
the first rounds on the device and the rest on the host, or all on the
host (``hostpath.HOST_BULLET_N`` lowered to pick the split), each held to
the all-host route's L_vec, R_vec, a_hat, b_hat, g_hat, blind_Gamma and
Gamma, and DotProductProofLog's Cx and proof bytes. On the CPU the device
rounds run the kernels' plain versions; the ``gpu`` case runs them on the
card at 8,192 entries: ``pytest -m gpu --noconftest tests/test_torch_bullet.py``.
"""

import pytest
import torch

from spartan_tpu_torch import device as DEV
from spartan_tpu_torch.core import hostpath as HP
from spartan_tpu_torch.core.bullet import BulletReductionProof
from spartan_tpu_torch.core.group import GroupElem
from spartan_tpu_torch.core.nizk import DotProductProofGens, DotProductProofLog
from spartan_tpu_torch.ops import curve as CU
from spartan_tpu_torch.ops import curve_host as CH
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import msm as M
from spartan_tpu_torch.ops.fields_host import FR_MOD
from spartan_tpu_torch.utils.math import log_2
from spartan_tpu_torch.utils.random_tape import RandomTape
from spartan_tpu_torch.utils.serialization import deserialize, serialize
from spartan_tpu_torch.utils.timer import Timer
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _bucket_msm(monkeypatch):
    """The device rounds' MSMs take H3/H4 (as on the card above 62
    entries), the last ones the ladder."""
    monkeypatch.setattr(M, "LADDER_N", 4)


def _values(n, salt):
    tape = RandomTape(b"bullet_values", seed=bytes([salt]) * 32)
    return tape.random_vector(b"v", n)


def _inputs(n, device):
    gens = DotProductProofGens(n, b"test_bullet")
    a, b = _values(n, 1), _values(n, 2)
    blinds = _values(2 * log_2(n) + 1, 3)
    Q = GroupElem(CH.scalar_mul(blinds[-1] + 5, CH.GEN))
    H = GroupElem(CH.scalar_mul(blinds[0] + 7, CH.GEN))
    return (gens, F.encode_fr(a, device=device), F.encode_fr(b, device=device),
            Q, H, blinds[-1], list(zip(blinds[0:-1:2], blinds[1:-1:2])))


def _bullet(inputs, cut, monkeypatch):
    """The reduction's outputs with the crossover at ``cut``, and the number
    of device rounds it ran."""
    gens, a, b, Q, H, blind, blinds_vec = inputs
    monkeypatch.setattr(HP, "HOST_BULLET_N", cut)
    Timer.collect()
    try:
        proof, Gamma, a_hat, b_hat, g_hat, blind_Gamma = BulletReductionProof.prove(
            Transcript(b"test_bullet"), Q, gens.gens_n.G, H, a, b, blind, blinds_vec)
        spans = [s.label for s in Timer.tree()]
    finally:
        Timer.collect(False)
        Timer.acc_reset()
    assert spans.count("bullet.reduce") == 1
    out = ([p.p for p in proof.L_vec], [p.p for p in proof.R_vec], a_hat, b_hat, g_hat.p,
           blind_Gamma, Gamma.p)
    return out, spans.count("bullet.device_round")


def _host_reference(n, a, b, gens, Q, H, blind, blinds_vec):
    """The all-host reduction, which the route parameters must equal."""
    with pytest.MonkeyPatch.context() as mp:
        return _bullet((gens, a, b, Q, H, blind, blinds_vec), n, mp)[0]


ROUTES = {"device": lambda n: 1, "split": lambda n: n // 2, "host": lambda n: n}


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bullet_routes_equal_host(n, route, monkeypatch):
    monkeypatch.setattr(HP, "HOST_MSM_N", 1)   # CPU rounds follow HOST_BULLET_N alone
    with DEV.use("cpu"):
        inputs = _inputs(n, "cpu")
        want = _host_reference(n, inputs[1], inputs[2], inputs[0], *inputs[3:])
        cut = ROUTES[route](n)
        got, rounds = _bullet(inputs, cut, monkeypatch)
    assert got == want
    assert rounds == log_2(n) - log_2(cut)


def _dotproduct_log(n, cut, monkeypatch, device):
    monkeypatch.setattr(HP, "HOST_BULLET_N", cut)
    gens = DotProductProofGens(n, b"test_bullet_log")
    x, a = _values(n, 4), _values(n, 5)
    y = sum(p * q for p, q in zip(x, a)) % FR_MOD
    proof, Cx, Cy = DotProductProofLog.prove(
        gens, Transcript(b"test_bullet_log"), RandomTape(b"tape", seed=bytes([9]) * 32),
        F.encode_fr(x, device=device), 17, F.encode_fr(a, device=device), y, 19)
    return gens, a, serialize(proof), Cx, Cy


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_dotproduct_log_routes_equal_host(route, monkeypatch):
    n = 8
    with DEV.use("cpu"):
        with monkeypatch.context() as mp:
            mp.setattr(HP, "HOST_MSM_N", 1)
            gens, a, raw, Cx, Cy = _dotproduct_log(n, ROUTES[route](n), mp, "cpu")
            _, _, want, Cx_host, Cy_host = _dotproduct_log(n, n, mp, "cpu")
        assert (raw, Cx, Cy) == (want, Cx_host, Cy_host)
        proof = deserialize(DotProductProofLog, raw)
        proof.verify(n, gens, Transcript(b"test_bullet_log"), a, Cx, Cy)


def test_cpu_rounds_keep_the_host_msm_threshold(monkeypatch):
    """On the CPU the rounds stay on the host up to HOST_MSM_N whatever the
    crossover: the plain versions lose to the host C there."""
    monkeypatch.setattr(HP, "HOST_BULLET_N", 1)
    monkeypatch.setattr(HP, "HOST_MSM_N", 8)
    cpu = torch.device("cpu")
    assert [HP.bullet_on_host(n, cpu) for n in (4, 8, 16)] == [True, True, False]
    assert [HP.bullet_on_host(n, torch.device("cuda")) for n in (1, 2, 8)] == \
        [True, False, False]


def test_host_inverse_and_decode_equal_the_device_forms():
    """The device rounds' normalisations (the product's inverse on the host,
    a few points decoded on the host) give the device forms' limbs."""
    pts = [CH.scalar_mul(k, CH.GEN) for k in (3, 5, 7)] + [None]
    proj = CU.encode_points(pts, "cpu")
    scale = F.encode_fq([11, 13, 17, 19], device="cpu")
    proj = tuple(F.fq.mul(c, scale) for c in proj)     # Z != 1
    assert all(torch.equal(x, y) for x, y in zip(CU.batch_normalize(proj, host=True),
                                                 CU.batch_normalize(proj)))
    assert CU.decode_few(proj) == CU.decode_points(proj) == pts
    z = F.encode_fq([0, 2, 9], device="cpu")
    assert torch.equal(F.fq.host_inv(z), F.fq.inv(z))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_rounds_equal_host_at_8192(cuda, monkeypatch):
    """The keyless openings' size on the card: the device route's outputs
    equal the host route's, and the card runs 13 - lg HOST_BULLET_N rounds."""
    n = 8192
    cut = HP.HOST_BULLET_N
    with DEV.use(cuda):
        inputs = _inputs(n, cuda)
        want = _host_reference(n, inputs[1], inputs[2], inputs[0], *inputs[3:])
        got, rounds = _bullet(inputs, cut, monkeypatch)
    assert got == want
    assert rounds == 13 - log_2(cut)
