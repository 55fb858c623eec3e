"""spartan_tpu_torch field ops (kernel H1's plain version on the CPU) against
host bigints and the JAX package's field_jax, on the same inputs.

Inputs are drawn with numpy from fixed seeds and handed to both packages
through spartan_tpu_torch.interop. Every comparison is exact. The JAX
package is imported inside the tests that use it, so the ``gpu`` tests run
where JAX is not installed (``pytest -m gpu --noconftest``).
"""

import numpy as np
import pytest
import torch

from spartan_tpu_torch import interop
from spartan_tpu_torch.ops import field as F
from spartan_tpu_torch.ops import fields_host as fh
from spartan_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints, to_tensor

from torch_threads import _one_thread  # noqa: F401

R = 1 << 256
SPECS = {"Fr": F.FR, "Fq": F.FQ}


def rand_ints(seed, n, p):
    """n field elements from numpy, with 0, 1 and p - 1 among them."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    xs = [v % p for v in limbs_to_ints(words)]
    xs[:3] = [0, 1, p - 1]
    return xs


def mont(xs, p):
    """Montgomery limbs (CPU tensor) of canonical ints."""
    return to_tensor(ints_to_limbs([x * R % p for x in xs]), "cpu")


def unmont(t, p):
    rinv = pow(R, -1, p)
    return [x * rinv % p for x in limbs_to_ints(t.reshape(-1, 8).numpy())]


def ops_of(name):
    return F.fr if name == "Fr" else F.fq


def test_limb_regroup_roundtrip():
    rng = np.random.default_rng(1)
    a16 = rng.integers(0, 1 << 16, size=(33, 16), dtype=np.uint32)
    a32 = interop.limbs16_to_32(a16)
    assert a32.dtype == np.int32 and a32.shape == (33, 8)
    assert np.array_equal(interop.limbs32_to_16(a32), a16)
    # same integers in both layouts
    from spartan_tpu.ops.limbs import limbs_to_ints as jax_limbs_to_ints

    assert limbs_to_ints(a32) == jax_limbs_to_ints(a16)
    t = interop.to_port(a16)
    assert np.array_equal(interop.from_port(t), a16)


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["mul", "add", "sub", "sqr"])
def test_binary_ops_vs_host(name, op):
    p = SPECS[name].modulus
    xs, ys = rand_ints(10, 40, p), rand_ints(11, 40, p)[::-1]
    a, b = mont(xs, p), mont(ys, p)
    ops = ops_of(name)
    got = unmont(ops.sqr(a) if op == "sqr" else getattr(ops, op)(a, b), p)
    want = {"mul": lambda x, y: x * y % p, "add": lambda x, y: (x + y) % p,
            "sub": lambda x, y: (x - y) % p, "sqr": lambda x, y: x * x % p}[op]
    assert got == [want(x, y) for x, y in zip(xs, ys)]


def test_ops_match_field_jax():
    """Bit-identical limbs to the JAX package's Fr mul on the same inputs."""
    p = fh.FR_MOD
    xs, ys = rand_ints(12, 16, p), rand_ints(13, 16, p)
    a, b = mont(xs, p), mont(ys, p)
    got = interop.from_port(F.fr.mul(a, b))
    import jax.numpy as jnp

    from spartan_tpu.ops import field_jax as FJ

    ja = jnp.asarray(interop.from_port(a))
    jb = jnp.asarray(interop.from_port(b))
    assert np.array_equal(np.asarray(FJ.fr.mul(ja, jb)), got)


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_scalar_broadcast(name):
    p = SPECS[name].modulus
    xs = rand_ints(14, 24, p)
    a = mont(xs, p)
    s = mont([123456789 * 987654321], p)[0]
    got = unmont(ops_of(name).mul(s, a), p)
    assert got == [123456789 * 987654321 * x % p for x in xs]
    # [1, 8] broadcasts the same way as [8]
    assert torch.equal(ops_of(name).add(s[None], a), ops_of(name).add(a, s))


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_neg_and_inv(name):
    p = SPECS[name].modulus
    xs = rand_ints(15, 6, p)
    a = mont(xs, p)
    ops = ops_of(name)
    assert unmont(ops.neg(a), p) == [(-x) % p for x in xs]
    assert unmont(ops.inv(a), p) == [pow(x, -1, p) if x else 0 for x in xs]


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_batch_inverse_with_zeros(name):
    p = SPECS[name].modulus
    xs = rand_ints(16, 21, p)
    xs[7] = 0
    got = unmont(ops_of(name).batch_inverse(mont(xs, p)), p)
    assert got == [pow(x, -1, p) if x else 0 for x in xs]


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_reduce_sum(name):
    p = SPECS[name].modulus
    xs = rand_ints(17, 300, p)
    a = mont(xs, p)
    assert unmont(ops_of(name).reduce_sum(a), p) == [sum(xs) % p]
    # along an inner axis, as the sumcheck reduces [..., N, 8] tables
    got = unmont(ops_of(name).reduce_sum(a.reshape(3, 100, 8), axis=-2), p)
    assert got == [sum(xs[i * 100:(i + 1) * 100]) % p for i in range(3)]


def test_reduce_sum_large_carry():
    """Maximal Montgomery residues drive every column sum and carry to its
    bound (the JAX package's regression, tests/test_field.py:74)."""
    p = fh.FR_MOD
    n = 4096
    worst = (p - 1) * pow(R, -1, p) % p
    a = mont([worst] * n, p)
    assert unmont(F.fr.reduce_sum(a), p) == [worst * n % p]
    xs = rand_ints(18, n, p)
    assert unmont(F.fr.reduce_sum(mont(xs, p)), p) == [sum(xs) % p]


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("host_convert", [True, False])
def test_encode_decode(name, host_convert, monkeypatch):
    spec = SPECS[name]
    p = spec.modulus
    monkeypatch.setattr(F, "_HOST_CONVERT_N", 1 << 20 if host_convert else 0)
    xs = rand_ints(19, 10, p)
    t = F.encode_fr(xs + [p + 5], spec, device="cpu")
    assert unmont(t, p) == xs + [5]
    assert F.decode_fr(t, spec) == xs + [5]


def test_mont_conversions():
    p = fh.FR_MOD
    xs = rand_ints(20, 9, p)
    canon = to_tensor(ints_to_limbs(xs), "cpu")
    m = F.fr.to_mont(canon)
    assert limbs_to_ints(m.numpy()) == [x * R % p for x in xs]
    assert limbs_to_ints(F.fr.from_mont(m).numpy()) == xs


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        F.field_ew("mul", F.FR, a.to(torch.int64), a)
    with pytest.raises(ValueError):
        F.field_ew("mul", F.FR, a[:, :7], a[:, :7])
    with pytest.raises(ValueError):
        F.launch_field_ew("mul", F.FR, a, 1, a, 1, 4)  # CPU tensors: no kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_h1_kernel_matches_plain(cuda, name):
    spec = SPECS[name]
    p = spec.modulus
    a = mont(rand_ints(21, 4096, p), p).to(cuda)
    b = mont(rand_ints(22, 4096, p), p).to(cuda)
    for op in ("mul", "add", "sub"):
        assert torch.equal(F.field_ew(op, spec, a, b), F.field_ew_plain(op, spec, a, b))
    assert torch.equal(F.field_ew("mul", spec, a[3], b), F.field_ew_plain("mul", spec, a[3], b))
