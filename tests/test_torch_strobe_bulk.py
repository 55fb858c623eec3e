"""STROBE's absorb of a long message in one native call.

``Strobe128._absorb`` hands a message of a rate block (166 bytes) or more
to ``strobe_absorb`` of ``native/spartan_native.c``; shorter messages, and
every host without the native library, keep the Python loop. Each case
holds the native call to the Python loop (forced by setting
``strobe._bulk_absorb`` to None): the 200-byte state, ``pos`` and
``pos_begin`` after it, or the transcript's challenges. The native
permutation is held to ``ops/keccak.py``'s Python one. All comparisons are
equality.
"""

import random

import pytest

from spartan_tpu_torch import native
from spartan_tpu_torch.ops.keccak import keccak_f1600
from spartan_tpu_torch.utils import strobe
from spartan_tpu_torch.utils.strobe import Strobe128
from spartan_tpu_torch.utils.timer import Timer
from spartan_tpu_torch.utils.transcript import Transcript

from torch_threads import _one_thread  # noqa: F401

LENGTHS = (0, 1, 165, 166, 167, 331, 332, 333, 100_003)
STARTS = (0, 1, 100, 165)


@pytest.fixture
def needs_native():
    if not native.available:
        pytest.skip("the native library did not build on this host (no C compiler)")


def _sponge(rng, pos, pos_begin):
    s = Strobe128.__new__(Strobe128)
    s.state, s.pos, s.pos_begin, s.cur_flags = bytearray(rng.randbytes(200)), pos, pos_begin, 0
    return s


def _python_absorb(monkeypatch, s, data):
    with monkeypatch.context() as m:
        m.setattr(strobe, "_bulk_absorb", None)
        s._absorb(data)


@pytest.mark.parametrize("pos", STARTS)
@pytest.mark.parametrize("n", LENGTHS)
def test_native_absorb_equals_python_loop(monkeypatch, needs_native, n, pos):
    rng = random.Random(n * 1000 + pos)
    data = rng.randbytes(n)
    for pos_begin in (0, pos + 1):
        py = _sponge(rng, pos, pos_begin)
        state = bytearray(py.state)
        _python_absorb(monkeypatch, py, data)
        got = native.strobe_absorb_native(state, pos, pos_begin, data)
        assert (bytes(state), got) == (bytes(py.state), (py.pos, py.pos_begin))


@pytest.mark.parametrize("seed", range(4))
def test_native_permutation_equals_python(needs_native, seed):
    rng = random.Random(seed)
    for _ in range(25):
        lanes = [rng.getrandbits(64) for _ in range(25)]
        state = bytearray(b"".join(v.to_bytes(8, "little") for v in lanes))
        native.keccak_f1600_bytes_native(state)
        want = keccak_f1600(lanes)
        assert [int.from_bytes(state[8 * i:8 * i + 8], "little") for i in range(25)] == want


def test_route_by_length(monkeypatch, needs_native):
    """Messages of a block or more take one native call, in a
    ``strobe.bulk_absorb`` span; shorter ones never reach it."""
    calls = []

    def counted(state, pos, pos_begin, data):
        calls.append(len(data))
        return native.strobe_absorb_native(state, pos, pos_begin, data)

    monkeypatch.setattr(strobe, "_bulk_absorb", counted)
    t = Transcript(b"route")
    for n in (0, 32, 64, 165):
        t.append_message(b"short", bytes(n))
    assert calls == []
    Timer.collect()
    try:
        t.append_message(b"long", bytes(166))
        t.append_message(b"long", bytes(10_000))
    finally:
        labels = [s.label for s in Timer.tree()]
        Timer.collect(False)
    assert calls == [166, 10_000]
    assert labels.count("strobe.bulk_absorb") == 2


@pytest.mark.parametrize("n", (3 * 2**20 + 7, 5 * 2**20))
def test_transcript_long_message_same_challenges(monkeypatch, needs_native, n):
    """A multi-megabyte append (as the NIZK's shape digest) gives the same
    challenges through the native path as through the Python loop."""
    data = random.Random(n).randbytes(n)

    def run():
        t = Transcript(b"bulk")
        t.append_scalar(b"before", 12345)
        t.append_message(b"R1CSShapeDigest", data)
        t.append_message(b"after", b"tail")
        return [t.challenge_scalar(b"c") for _ in range(3)], bytes(t.strobe.state)

    with monkeypatch.context() as m:
        m.setattr(strobe, "_bulk_absorb", None)
        want = run()
    assert strobe._bulk_absorb is not None
    assert run() == want
