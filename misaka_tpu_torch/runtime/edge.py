"""The HTTP edge: TLS on the listener, and where an API keyfile resolves.

The port of the TLS half of misaka_tpu/runtime/edge.py
(`tls_context_from_env`, `wrap_server_tls`) and of `keyfile_path`.  The
rest of the reference's edge (API keys, tenant quotas, admission, signed
tenant tokens) is not ported yet (ROADMAP A.2): the app refuses to boot
when a keyfile resolves, since an open server is worse than none.
"""

from __future__ import annotations

import os
import ssl


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
