"""The port's decimal codec gives the JAX package's bytes and errors.

misaka_tpu_torch/utils/textcodec.py is the port's own copy of the numpy path
of misaka_tpu/utils/textcodec.py.  Every case of tests/test_textcodec.py is
run through both: formatted bytes must be identical, parsed arrays equal,
and a malformed input must raise in both.  The reference runs with its
default backend (the native one where a toolchain exists), which its own
differential tests pin byte-identical to its numpy path.
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
