"""Shared HTTP scaffolding for the coordinator and worker servers."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class JsonHandler(BaseHTTPRequestHandler):
    """Quiet request handler with a JSON response helper.

    Speaks HTTP/1.1 with keep-alive: every response helper sends an
    explicit Content-Length (and 204 has no body), so one connection
    carries a client's whole protocol conversation — the serving fast
    path answers repeated SELECTs without paying a TCP connect plus a
    server thread spawn per request. Clients that prefer one-shot
    semantics (urllib sends ``Connection: close``) are unaffected."""

    protocol_version = "HTTP/1.1"
    # idle keep-alive connections release their handler thread after
    # this; in-conversation requests arrive back-to-back, far inside it
    timeout = 120
    # small request/response pairs ping-pong on a persistent socket:
    # Nagle + delayed ACK would add ~40ms per exchange
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send_json(self, obj, status: int = 200,
                   extra_headers: dict | None = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length))

    def _send_html(self, html: str, status: int = 200) -> None:
        body = html.encode()
        self.send_response(status)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_bytes(self, body, status: int = 200,
                    extra_headers: dict | None = None,
                    content_type: str | None = None) -> None:
        """``body`` may be bytes or a memoryview (mmap-served spool
        pages write to the socket without a heap copy).
        ``content_type`` overrides the octet-stream default (the wire
        codecs' vnd types for negotiated exchange/result pages)."""
        self.send_response(status)
        self.send_header("Content-Type",
                         content_type or "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)


# process-wide client-side TLS context: set by enable_client_tls() so
# every internal HTTP client (coordinator -> worker RPC, worker ->
# worker exchange fetch, protocol client) verifies the cluster's
# certificate (reference InternalCommunicationConfig https setup /
# server/security/ServerSecurityModule.java)
_CLIENT_SSL_CONTEXT = None


def enable_client_tls(cafile: str,
                      check_hostname: bool = True) -> None:
    import ssl
    global _CLIENT_SSL_CONTEXT
    _CLIENT_SSL_CONTEXT = ssl.create_default_context(cafile=cafile)
    _CLIENT_SSL_CONTEXT.check_hostname = check_hostname


def disable_client_tls() -> None:
    global _CLIENT_SSL_CONTEXT
    _CLIENT_SSL_CONTEXT = None


def client_ssl_context():
    return _CLIENT_SSL_CONTEXT


def urlopen(req, timeout: float = 60.0):
    """urllib.request.urlopen with the cluster TLS context applied."""
    import urllib.request
    return urllib.request.urlopen(req, timeout=timeout,
                                  context=_CLIENT_SSL_CONTEXT)


class HttpService:
    """Owns a ThreadingHTTPServer + daemon serve thread lifecycle.
    ``tls`` = (certfile, keyfile) serves HTTPS (reference
    HttpServerConfig https enable)."""

    def __init__(self, handler_cls, host: str = "127.0.0.1",
                 port: int = 0, tls: tuple[str, str] | None = None):
        scheme = "http"
        if tls is not None:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=tls[0], keyfile=tls[1])

            class _TLSServer(ThreadingHTTPServer):
                # handshake runs in the PER-CONNECTION handler thread:
                # wrapping the listening socket instead would perform
                # every handshake inside the single accept loop, where
                # one slow client stalls the whole server (exchange
                # long-polls + pings + task POSTs connect concurrently)
                def finish_request(self, request, client_address):
                    try:
                        request = ctx.wrap_socket(request,
                                                  server_side=True)
                    except (OSError, ssl.SSLError):
                        return  # failed handshake: drop connection
                    super().finish_request(request, client_address)

            self.httpd = _TLSServer((host, port), handler_cls)
            scheme = "https"
        else:
            self.httpd = ThreadingHTTPServer((host, port), handler_cls)
        self.port = self.httpd.server_address[1]
        self.uri = f"{scheme}://{host}:{self.port}"
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
