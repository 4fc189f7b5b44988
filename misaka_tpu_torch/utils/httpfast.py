"""Minimal HTTP/1.1 request parsing for the serving front.

The port's own copy of misaka_tpu/utils/httpfast.py.  The stock
BaseHTTPRequestHandler routes every request's headers through
email.feedparser, about 100 us of pure Python per request.
`fast_parse_request` reads the request line and headers with a tight loop
into a dict, keeping the stock limits (65536-byte lines, 100 headers) and
keep-alive semantics.  runtime/master.py uses it unless MISAKA_FAST_HTTP=0.
"""

from __future__ import annotations


class FastHeaders:
    """Case-insensitive header lookup over a plain dict — the minimal
    stand-in for email.message.Message that the serving-plane routes use
    (they only ever call .get)."""

    __slots__ = ("_d",)

    def __init__(self, d: dict[str, str]):
        self._d = d

    def get(self, name: str, default=None):
        return self._d.get(name.lower(), default)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._d

    def items(self):
        return self._d.items()


def fast_parse_request(handler):
    """Parse handler.raw_requestline + headers from handler.rfile.

    Returns True when it parsed the request (handler.command/path/
    headers/close_connection are set), False to fall back to the stock
    parser (odd request lines, HTTP/0.9 — shapes where the canonical
    stdlib error handling matters more than speed), or None when it
    already ANSWERED an error (431) and the caller must not dispatch.
    Falling back is impossible once header bytes are consumed, so the
    fast path decides on the REQUEST LINE alone; everything after that
    is handled here.
    """
    line = handler.raw_requestline.decode("latin-1")
    words = line.split()
    if len(words) != 3:
        return False  # HTTP/0.9 or malformed: stock parser owns the shape
    command, path, version = words
    if version not in ("HTTP/1.1", "HTTP/1.0"):
        return False
    headers: dict[str, str] = {}
    while True:
        hline = handler.rfile.readline(65537)
        if len(hline) > 65536:
            handler.requestline = line.rstrip("\r\n")
            handler.command, handler.path = command, path
            handler.request_version = version
            handler.close_connection = True
            handler.send_error(431, "Line too long")
            return None  # answered; the caller must not dispatch
        if hline in (b"\r\n", b"\n", b""):
            break
        if len(headers) >= 100:
            handler.requestline = line.rstrip("\r\n")
            handler.command, handler.path = command, path
            handler.request_version = version
            handler.close_connection = True
            handler.send_error(431, "Too many headers")
            return None
        key, sep, value = hline.partition(b":")
        if not sep:
            continue  # ignore junk lines (lenient, like the email parser)
        headers[key.strip().decode("latin-1").lower()] = (
            value.strip().decode("latin-1")
        )
    handler.command = command
    handler.path = path
    handler.request_version = version
    handler.requestline = line.rstrip("\r\n")
    handler.headers = FastHeaders(headers)
    conntype = headers.get("connection", "").lower()
    if version == "HTTP/1.0":
        handler.close_connection = "keep-alive" not in conntype
    else:
        handler.close_connection = "close" in conntype
    if headers.get("expect", "").lower() == "100-continue" \
            and version == "HTTP/1.1":
        # the stock handle_expect_100 handshake (headers are already
        # consumed here, so falling back to the stock parser is not an
        # option; mimic it exactly)
        handler.send_response_only(100)
        handler.end_headers()
    return True
