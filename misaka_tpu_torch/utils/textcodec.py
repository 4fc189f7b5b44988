"""Vectorized decimal text codec for int32 value streams (/compute_batch).

The port's own copy of misaka_tpu/utils/textcodec.py.  Same accepted
syntax, same bytes out, same ValueErrors:

- `ints_to_dec(arr, sep, zero_pad=False)` -- ints -> decimal tokens joined
  by one separator byte.  Tokens are right-aligned in fixed-width fields
  (the width of the widest value in the call), padded with spaces -- legal
  JSON whitespace, so a comma-joined stream drops straight into a JSON
  array.  `zero_pad=True` pads with '0' instead (not legal JSON).
- `dec_to_ints(text)` -- separator-joined decimal text -> int32.  A
  fixed-stride stream (everything `ints_to_dec` emits) parses through a
  reshape; anything ragged falls back to a general parser.  Malformed input
  raises ValueError either way.

Both directions carry a native single-pass C++ fast path (the port's copy
of the reference's native/textcodec.cpp, csrc/native/textcodec.cpp, built
by utils/nativelib.py at first use; the GIL is released for the whole
call).  `MISAKA_NATIVE_CODEC` unset means auto (native where it builds),
`0` forces the numpy path, `1` requires the native codec and raises
without it.  tests/test_torch_textcodec.py holds the two paths and the JAX
package byte for byte.
"""

from __future__ import annotations

import ctypes
import os
import warnings

import numpy as np

from misaka_tpu_torch.utils.nativelib import NativeLib


def _configure(lib: ctypes.CDLL) -> None:
    lib.misaka_fmt_i32.restype = ctypes.c_int64
    lib.misaka_fmt_i32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_uint8,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.misaka_parse_i32.restype = ctypes.c_int64
    lib.misaka_parse_i32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]


_NATIVE = NativeLib("textcodec", _configure)


def _native_lib() -> ctypes.CDLL | None:
    """The codec library per MISAKA_NATIVE_CODEC: auto (unset), 0 off, 1 required."""
    knob = os.environ.get("MISAKA_NATIVE_CODEC", "").strip()
    if knob == "0":
        return None
    lib = _NATIVE.load()
    if lib is None and knob == "1":
        raise RuntimeError("MISAKA_NATIVE_CODEC=1 but no native codec (no g++?)")
    return lib


def native_available() -> bool:
    return _NATIVE.available()


_SEPS = (ord(" "), ord(","), ord("+"), ord("\t"), ord("\n"), ord("\r"))
_SEP_TABLE = bytes.maketrans(b",+\t\n\r", b"     ")
_IS_SEP = np.zeros(256, bool)
_IS_SEP[list(_SEPS)] = True  # byte -> is-separator lookup table

# np.fromstring(sep=...) is numpy's one C-speed text parser; it warns
# DeprecationWarning per call, so one narrow filter is installed at import
# (catch_warnings per call is not thread-safe under a threading server).
_FROMSTRING = getattr(np, "fromstring", None)
if _FROMSTRING is not None:
    warnings.filterwarnings(
        "ignore", message=".*fromstring.*", category=DeprecationWarning
    )

_THRESHOLDS = (10 ** np.arange(1, 10, dtype=np.int64)).astype(np.uint32)
# ord('0') * (10^w - 1)/9: what the matvec over '0'-padded ASCII bytes
# overshoots the digit value by, per token width
_ASCII_OFFSET = [ord("0") * (10**w - 1) // 9 for w in range(12)]


def ints_to_dec(arr: np.ndarray, sep: bytes = b" ", zero_pad: bool = False) -> bytes:
    """Format an int array as separator-joined decimal tokens (no leading or
    trailing separator), in O(max_digits) vectorized passes."""
    if len(sep) != 1:
        raise ValueError("sep must be a single byte")
    a = np.asanyarray(arr)
    n = a.size
    if n == 0:
        return b""
    if a.dtype == np.int32:
        lib = _native_lib()
        if lib is not None:
            src = np.ascontiguousarray(a.ravel())
            # width <= 11 (10 digits and the sign column): field and separator <= 12 bytes
            out = np.empty(12 * n, np.uint8)
            rc = lib.misaka_fmt_i32(
                src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
                sep[0], int(zero_pad),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
            )
            if rc >= 0:
                return out[:rc].tobytes()
    v = a.astype(np.int64).ravel()
    neg = v < 0
    mag = np.where(neg, -v, v).astype(np.uint32)  # int32 min fits unsigned

    nd_max = len(str(int(mag.max())))  # widest token this call, 1..10
    # digit columns in display order (most significant first)
    pows = (10 ** np.arange(nd_max - 1, -1, -1, dtype=np.int64)).astype(np.uint32)
    digits = (mag[:, None] // pows[None, :]) % 10  # [N, nd_max] uint32

    width = nd_max + 1  # one extra column so a full-width token fits its '-'
    field = np.empty((n, width + 1), np.uint8)  # +1 separator column
    field[:, width] = sep[0]
    if zero_pad:
        field[:, 1:width] = digits.astype(np.uint8) + ord("0")
        field[:, 0] = np.where(neg, np.uint8(ord("-")), np.uint8(ord("0")))
    else:
        pad = sep[0] if sep in (b" ", b"+") else ord(" ")
        ndig = (
            np.searchsorted(_THRESHOLDS[: nd_max - 1], mag, side="right") + 1
        ).astype(np.int64)
        # column j of the digit block shows iff it is among the token's
        # ndig rightmost columns
        col = np.arange(nd_max, dtype=np.int64)
        show = col[None, :] >= (nd_max - ndig)[:, None]
        field[:, 1:width] = np.where(
            show, (digits + ord("0")).astype(np.uint8), np.uint8(pad)
        )
        field[:, 0] = pad
        # '-' sits immediately left of the top digit
        rows = np.nonzero(neg)[0]
        field[rows, width - 1 - ndig[rows]] = ord("-")
    return field.tobytes()[:-1]  # drop the trailing separator


def _parse_fixed(raw: np.ndarray) -> np.ndarray | None:
    """Fixed-stride parse: tokens of equal width, one separator byte between.

    Returns None on any anomaly, so the general parser stays the single
    arbiter of what is an error and what is merely ragged."""
    is_digit = (raw >= ord("0")) & (raw <= ord("9"))
    is_minus = raw == ord("-")
    is_sep = (
        (raw == ord(" ")) | (raw == ord(",")) | (raw == ord("+"))
        | (raw == ord("\t")) | (raw == ord("\n")) | (raw == ord("\r"))
    )
    if not (is_digit | is_minus | is_sep).all():
        return None
    tok = is_digit | is_minus
    first_tok = int(np.argmax(tok))
    if not tok[first_tok]:
        return None  # no token chars at all
    # the first separator after the first token char ends the first field
    rel = int(np.argmax(is_sep[first_tok:]))
    if not is_sep[first_tok + rel]:
        return None  # single token, no separator
    stride = first_tok + rel + 1
    if (raw.size + 1) % stride:
        return None
    if stride - 1 > 11:
        return None  # wider than any int32 token: the general parser decides
    n = (raw.size + 1) // stride

    def grid(flags, fill):
        """[N, stride] contiguous bool: `flags` plus one synthesized tail."""
        out = np.empty(raw.size + 1, bool)
        out[:-1] = flags
        out[-1] = fill
        return out.reshape(n, stride)

    if not grid(is_sep, True)[:, -1].all():
        return None  # separators not on the stride grid
    if not grid(is_digit, False)[:, -2].all():
        return None  # every token must end in a digit at the field edge
    # token chars must form a suffix of each field: exactly one
    # token->separator transition per field
    if int(np.count_nonzero(tok[:-1] & ~tok[1:])) + int(tok[-1]) != n:
        return None
    min_rows = np.nonzero(is_minus)[0] // stride
    if min_rows.size:
        tok2 = grid(tok, False)
        m2 = grid(is_minus, False)
        if (m2[:, 1:-1] & tok2[:, :-2]).any():
            return None  # '-' mid-token
    # magnitude by one matvec over the right-aligned digit columns; float64
    # is exact far past the 10-digit int32 range
    dchars = np.empty(raw.size + 1, np.uint8)
    dchars[:-1] = np.where(is_digit, raw, np.uint8(ord("0")))
    dchars[-1] = ord("0")
    d = dchars.astype(np.float64).reshape(n, stride)
    val = d[:, :-1] @ (10.0 ** np.arange(stride - 2, -1, -1)) \
        - _ASCII_OFFSET[stride - 1]
    if min_rows.size:
        neg = np.zeros(n, bool)
        neg[min_rows] = True
        if (val > np.where(neg, 2.0**31, 2.0**31 - 1)).any():
            return None  # out of int32 range: the general path re-checks
        val = np.where(neg, -val, val)
    elif (val > 2.0**31 - 1).any():
        return None
    return val.astype(np.int32)


def dec_to_ints(text: bytes | str) -> np.ndarray:
    """Parse whitespace/comma/plus-separated decimal tokens to int32.

    Raises ValueError on malformed input (non-numeric tokens or characters
    outside [0-9 space tab newline , + -])."""
    if isinstance(text, str):
        text = text.encode("ascii", errors="strict")
    raw = np.frombuffer(text, np.uint8)
    if raw.size == 0:
        return np.empty((0,), np.int32)
    lib = _native_lib()
    if lib is not None:
        if not isinstance(text, bytes):  # bytearray or memoryview: c_char_p takes bytes
            text = bytes(text)
        # every token but the last needs a separator byte, so (len+1)//2
        # bounds the token count
        out = np.empty((raw.size + 1) // 2, np.int32)
        rc = lib.misaka_parse_i32(
            text, raw.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size,
        )
        if rc < 0:
            raise ValueError("cannot parse values")
        return out[:rc].copy()
    fixed = _parse_fixed(raw)
    if fixed is not None:
        return fixed

    # --- general (ragged) path ----------------------------------------------
    is_digit = (raw >= ord("0")) & (raw <= ord("9"))
    is_sep = _IS_SEP[raw]
    is_minus = raw == ord("-")
    if not (is_digit | is_sep | is_minus).all():
        raise ValueError("cannot parse values")
    tok = is_digit | is_minus
    starts = tok & ~np.concatenate(([False], tok[:-1]))
    # '-' must start a token and be followed by a digit
    nxt_digit = np.concatenate((is_digit[1:], [False]))
    if (is_minus & (~starts | ~nxt_digit)).any():
        raise ValueError("cannot parse values")
    n_tokens = int(starts.sum())
    if n_tokens == 0:
        return np.empty((0,), np.int32)
    cleaned = bytes(text).translate(_SEP_TABLE).decode("ascii")
    try:
        if _FROMSTRING is not None:
            out = _FROMSTRING(cleaned, dtype=np.int64, sep=" ")
        else:  # np.fromstring removed (future numpy)
            out = np.array(cleaned.split(), dtype=np.int64)
    except OverflowError:
        raise ValueError("cannot parse values") from None
    # np.fromstring stops silently at what it cannot parse; the charset
    # check plus a token-count match makes that loud
    if out.size != n_tokens:
        raise ValueError("cannot parse values")
    if ((out > 2**31 - 1) | (out < -(2**31))).any():
        raise ValueError("cannot parse values")
    return out.astype(np.int32)
