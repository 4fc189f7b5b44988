"""The HTTP edge: TLS on the listener, where an API keyfile resolves, and
the compute plane's shared-secret handshake.

The port of the TLS half of misaka_tpu/runtime/edge.py
(`tls_context_from_env`, `wrap_server_tls`), of `keyfile_path` and
`key_from_headers`, of the plane half the frontend tier needs
(`drain_or_close`, the MISAKA_PLANE_SECRET handshake) and of
`EdgeReject`'s wire form, which a frontend worker unpacks from a rejected
plane frame.  The rest of the reference's edge (API keys, tenant quotas,
admission, signed tenant tokens) is not ported yet (ROADMAP A.2): the app
refuses to boot when a keyfile resolves, since an open server is worse
than none.  Plane mTLS (MISAKA_PLANE_TLS_*) belongs to the multi-host
fleet (ROADMAP A.6) and refuses at boot too.  Stdlib only: the frontend
workers import this module.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import ssl

log = logging.getLogger("misaka_tpu_torch.edge")


class EdgeReject(Exception):
    """A typed edge rejection: HTTP status, machine-readable reason and an
    optional Retry-After in seconds.  An engine's plane answers a rejected
    frame with it as a JSON body, from which the frontend worker restores
    the headers."""

    def __init__(self, status: int, reason: str, message: str,
                 retry_after: float | None = None, tenant: str | None = None):
        super().__init__(message)
        self.status = int(status)
        self.reason = reason
        self.message = message
        self.retry_after = retry_after
        self.tenant = tenant

    def headers(self) -> list[tuple[str, str]]:
        out = []
        if self.retry_after is not None:
            # ceil to whole seconds: Retry-After is delta-seconds
            out.append(("Retry-After", str(max(1, int(-(-self.retry_after // 1))))))
        if self.status == 401:
            out.append(("WWW-Authenticate", 'Bearer realm="misaka", charset="UTF-8"'))
        return out

    @staticmethod
    def from_wire(status: int, body: bytes) -> "EdgeReject | None":
        """A rejected frame's JSON body ({"error", "reason", "retry_after",
        "tenant"}, the reference's `to_wire`), or None when the body is not
        an edge payload."""
        try:
            obj = json.loads(body.decode())
            if not isinstance(obj, dict) or "reason" not in obj:
                return None
            return EdgeReject(
                status, str(obj["reason"]), str(obj.get("error", "")),
                retry_after=float(obj["retry_after"])
                if obj.get("retry_after") is not None else None,
                tenant=str(obj["tenant"]) if obj.get("tenant") is not None else None,
            )
        except (ValueError, TypeError, UnicodeDecodeError):
            return None


def key_from_headers(headers) -> str | None:
    """The presented API key: X-Misaka-Key, or Authorization: Bearer."""
    k = headers.get("X-Misaka-Key")
    if k:
        return k
    auth = headers.get("Authorization")
    if auth and auth.startswith("Bearer "):
        return auth[len("Bearer "):].strip() or None
    return None


def keyfile_path(environ=os.environ) -> str | None:
    """MISAKA_API_KEYS, or the conventional <MISAKA_PROGRAMS_DIR>/
    api_keys.json when that file exists."""
    p = environ.get("MISAKA_API_KEYS")
    if p:
        return p
    d = environ.get("MISAKA_PROGRAMS_DIR")
    if d:
        conv = os.path.join(d, "api_keys.json")
        if os.path.exists(conv):
            return conv
    return None


def tls_context_from_env(environ=os.environ) -> ssl.SSLContext | None:
    """A server-side SSLContext from MISAKA_TLS_CERT/MISAKA_TLS_KEY (None
    when both are unset: plain HTTP).  One without the other raises, and
    so does a cert/key that fails to load: a server that fell back to
    plaintext would be worse than one that refused to boot."""
    cert = environ.get("MISAKA_TLS_CERT")
    key = environ.get("MISAKA_TLS_KEY")
    if not cert and not key:
        return None
    if not cert or not key:
        raise ValueError("MISAKA_TLS_CERT and MISAKA_TLS_KEY must be set together")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert, key)
    return ctx


def wrap_server_tls(httpd, context: ssl.SSLContext | None):
    """Wrap an already-bound http.server socket for TLS (no-op when
    `context` is None); returns httpd.

    The handshake is deferred (do_handshake_on_connect=False): run inside
    accept(), the server's single accept loop, one client that connects
    and sends nothing (a plaintext prober) would stall every other client.
    Deferred, it happens on the handler thread's first read."""
    if context is not None:
        httpd.socket = context.wrap_socket(
            httpd.socket, server_side=True, do_handshake_on_connect=False
        )
        httpd.misaka_tls = True
    return httpd


def drain_or_close(handler, max_drain: int = 65536) -> None:
    """The keep-alive discipline of a surface that rejects a POST before
    its route body runs: a small unread body is drained (the connection
    stays synchronized), a bulk or unparseable one closes the connection,
    so rejecting at the door never buffers the flood it is shedding."""
    try:
        length = int(handler.headers.get("Content-Length") or 0)
    except ValueError:
        length = -1
    if 0 <= length <= max_drain:
        handler.rfile.read(length)
    else:
        handler.close_connection = True


# --- compute-plane shared secret ---------------------------------------------

_PLANE_TAG = b"misaka-plane-v1"
PLANE_HANDSHAKE_LEN = 32


def plane_secret(environ=os.environ) -> bytes | None:
    """MISAKA_PLANE_SECRET, or the contents of MISAKA_PLANE_SECRET_FILE
    (None: an open plane)."""
    s = environ.get("MISAKA_PLANE_SECRET")
    if s:
        return s.encode()
    p = environ.get("MISAKA_PLANE_SECRET_FILE")
    if p:
        try:
            with open(p, "rb") as f:
                return f.read().strip() or None
        except OSError:
            log.error("edge: plane secret file %s unreadable", p)
            return None
    return None


def plane_handshake(secret: bytes) -> bytes:
    """The 32 bytes a plane client writes right after connect()."""
    return hmac.new(secret, _PLANE_TAG, hashlib.sha256).digest()


def verify_plane_handshake(secret: bytes, presented: bytes) -> bool:
    return hmac.compare_digest(plane_handshake(secret), presented)
