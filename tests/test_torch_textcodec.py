"""The port's decimal codec gives the JAX package's bytes and errors.

misaka_tpu_torch/utils/textcodec.py is the port's own copy of
misaka_tpu/utils/textcodec.py, its numpy path and its native one (the
port's copy of native/textcodec.cpp).  Every case of tests/test_textcodec.py
is run through both packages with their default backend: formatted bytes
must be identical, parsed arrays equal, and a malformed input must raise in
both.  The differential lane then holds four codecs against each other on
the reference's corpus (the port's native and numpy paths, the JAX
package's native and numpy paths, chosen by MISAKA_NATIVE_CODEC, which both
read): equal bytes, equal arrays, a ValueError from each on the same
inputs; and MISAKA_NATIVE_CODEC=0/1 behave as the reference's.
"""

import numpy as np
import pytest

from misaka_tpu.utils import textcodec as jcodec
from misaka_tpu_torch.utils import textcodec as tcodec

EDGES = np.array(
    [0, 1, -1, 9, 10, -10, 99, 100, 2**31 - 1, -(2**31), 123456789, -987654321],
    np.int32,
)
SEPS = [b" ", b",", b"+"]


def random_arrays():
    rng = np.random.default_rng(42)
    return [rng.integers(lo, hi, size=10_000).astype(np.int32)
            for lo, hi in ((-10, 10), (-1000, 1000), (-2**31, 2**31))]


@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("sep", SEPS)
def test_format_bytes_match_jax(sep, zero_pad):
    for arr in [EDGES, np.empty((0,), np.int32), *random_arrays()]:
        got = tcodec.ints_to_dec(arr, sep, zero_pad=zero_pad)
        assert got == jcodec.ints_to_dec(arr, sep, zero_pad=zero_pad)
        if not zero_pad:
            np.testing.assert_array_equal(tcodec.dec_to_ints(got), arr)


@pytest.mark.parametrize("sep", SEPS)
def test_parse_matches_jax(sep):
    texts = [tcodec.ints_to_dec(a, sep) for a in [EDGES, *random_arrays()]]
    texts += [b"", "  , \t\n", "1, 2 3,4\t5\n-6", "7", " 12,", "+3+4+"]
    for text in texts:
        got, want = tcodec.dec_to_ints(text), jcodec.dec_to_ints(text)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "bad",
    ["1 two 3", "5x", "x5", "--5", "5-", "5-6", "1.5", "0x10",
     "9999999999999", "-9999999999999", "2147483648", "-2147483649", "-", "- 5",
     "999999999999 999999999999", "999999999999,999999999999"],
)
def test_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jcodec.dec_to_ints(bad)
    with pytest.raises(ValueError):
        tcodec.dec_to_ints(bad)


def test_rejects_non_ascii():
    with pytest.raises((ValueError, UnicodeEncodeError)):
        tcodec.dec_to_ints("１２３")


def test_rejects_a_wide_separator():
    with pytest.raises(ValueError):
        tcodec.ints_to_dec(EDGES, b", ")


# --- the native/numpy differential lane, across both packages ---------------------

needs_native = pytest.mark.skipif(not tcodec.native_available(),
                                  reason="no C++ toolchain for the native codec")
CODECS = [(pkg, knob) for pkg in ("port", "jax") for knob in ("1", "0")]


def _all_four(monkeypatch, call):
    """call(module) under each package and backend: {(pkg, knob): result}."""
    out = {}
    for pkg, knob in CODECS:
        monkeypatch.setenv("MISAKA_NATIVE_CODEC", knob)
        out[(pkg, knob)] = call(tcodec if pkg == "port" else jcodec)
    return out


@needs_native
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("sep", SEPS)
def test_native_format_byte_exact(monkeypatch, sep, zero_pad):
    rng = np.random.default_rng(11)
    for arr in (EDGES, np.zeros(7, np.int32), rng.integers(-9, 10, size=501).astype(np.int32),
                rng.integers(-(2**31), 2**31, size=5000).astype(np.int32)):
        got = _all_four(monkeypatch, lambda c: c.ints_to_dec(arr, sep, zero_pad))
        assert len(set(got.values())) == 1, {k: v[:40] for k, v in got.items()}


@needs_native
def test_native_parse_identical(monkeypatch):
    rng = np.random.default_rng(12)
    arr = rng.integers(-(2**31), 2**31, size=5000).astype(np.int32)
    streams = [
        tcodec.ints_to_dec(arr, b" "),
        tcodec.ints_to_dec(arr, b"+", zero_pad=True),
        b"1, 2 3,4\t5\n-6",
        b"-2147483648 2147483647",
        b"0000005 -08 -0 0000000000005",  # leading zeros, ragged widths
        b"7",  # a single token, no separator
        b"7\n",  # a trailing separator
        b"  , \t\n",  # separators only: empty
    ]
    for txt in streams:
        got = _all_four(monkeypatch, lambda c: c.dec_to_ints(txt))
        for k, v in got.items():
            assert v.dtype == np.int32, k
            np.testing.assert_array_equal(v, got[("jax", "0")], err_msg=str(k))


@needs_native
@pytest.mark.parametrize(
    "bad",
    ["1 two 3", "5x", "--5", "5-", "5-6", "1.5", "2147483648", "-2147483649", "-", "- 5",
     "99999999999999999999 1", "999999999999,999999999999", "\x005"],
)
def test_native_rejects_match(monkeypatch, bad):
    def rejects(c):
        with pytest.raises(ValueError) as e:
            c.dec_to_ints(bad)
        return str(e.value)

    assert set(_all_four(monkeypatch, rejects).values()) == {"cannot parse values"}


@needs_native
def test_native_fuzz_roundtrip(monkeypatch):
    """Random arrays through every package, backend, separator and padding:
    the formatted bytes equal, each parse gives the input back."""
    rng = np.random.default_rng(13)
    for trial in range(25):
        n = int(rng.integers(1, 2000))
        lo, hi = sorted(rng.integers(-(2**31), 2**31, size=2).tolist())
        arr = rng.integers(lo, hi + 1, size=n, dtype=np.int64).astype(np.int32)
        sep, zp = SEPS[trial % 3], bool(trial % 2)
        got = _all_four(monkeypatch, lambda c: c.ints_to_dec(arr, sep, zp))
        assert len(set(got.values())) == 1, f"trial {trial}"
        text = got[("port", "1")]
        for parsed in _all_four(monkeypatch, lambda c: c.dec_to_ints(text)).values():
            np.testing.assert_array_equal(parsed, arr)


@needs_native
def test_native_accepts_bytearray(monkeypatch):
    got = _all_four(monkeypatch, lambda c: c.dec_to_ints(bytearray(b"1 2 -3")))
    for v in got.values():
        np.testing.assert_array_equal(v, np.array([1, 2, -3], np.int32))


@needs_native
def test_native_codec_knob(monkeypatch):
    """Unset: the native codec where it builds; 0: numpy; 1: native, and a
    missing one raises instead of falling back."""
    monkeypatch.delenv("MISAKA_NATIVE_CODEC", raising=False)
    assert tcodec._native_lib() is tcodec._NATIVE.load() is not None
    monkeypatch.setenv("MISAKA_NATIVE_CODEC", "0")
    assert tcodec._native_lib() is None
    monkeypatch.setenv("MISAKA_NATIVE_CODEC", "1")
    assert tcodec._native_lib() is not None

    class Missing:
        def load(self):
            return None

        def available(self):
            return False

    monkeypatch.setattr(tcodec, "_NATIVE", Missing())
    with pytest.raises(RuntimeError, match="MISAKA_NATIVE_CODEC=1 but no native codec"):
        tcodec.ints_to_dec(EDGES)
    with pytest.raises(RuntimeError, match="MISAKA_NATIVE_CODEC=1 but no native codec"):
        tcodec.dec_to_ints(b"1 2")
    # auto falls back to numpy, with the same bytes
    monkeypatch.delenv("MISAKA_NATIVE_CODEC")
    assert not tcodec.native_available()
    assert tcodec.ints_to_dec(EDGES, b",") == jcodec.ints_to_dec(EDGES, b",")
    np.testing.assert_array_equal(tcodec.dec_to_ints(b"1 2 -3"), [1, 2, -3])


def test_native_codec_builds_from_the_port_copy():
    if not tcodec.native_available():
        pytest.skip("no C++ toolchain for the native codec")
    assert tcodec._NATIVE.src.endswith("misaka_tpu_torch/csrc/native/textcodec.cpp")
    assert tcodec._NATIVE.src_hash() == jcodec._NATIVE._src_hash()
