"""Client library: submit SQL over the REST protocol, follow nextUri.

Analog of the reference's trino-client StatementClientV1
(client/trino-client/.../StatementClientV1.java:61,323-335): POST the
statement, then advance() along nextUri until the server stops returning
one, accumulating data pages. Results STREAM: the server delivers pages
while the query is still RUNNING (bounded producer queue, see
server/results.py), so the loop drains data as it appears and only
sleeps on genuinely empty polls.

``result_format="arrow"`` asks the server for binary result pages
(``X-Presto-TPU-Result: arrow``): each nextUri fetch returns the wire
codec's Arrow bytes untouched, decoded client-side into the SAME row
values the JSON path yields.
"""

from __future__ import annotations

import http.client
import io
import json
import re
import threading
import time
import urllib.error
from urllib.parse import urlsplit


class QueryFailed(Exception):
    """Carries the protocol error code (reference errorName —
    QUERY_QUEUE_FULL, CLUSTER_OUT_OF_MEMORY, EXCEEDED_TIME_LIMIT, ...)
    so callers triage overload shedding vs real failures."""

    def __init__(self, message: str, error_name: str | None = None):
        super().__init__(message)
        self.error_name = error_name


class Client:
    def __init__(self, base_url: str, user: str = "presto",
                 password: str | None = None,
                 result_format: str = "json"):
        self.base_url = base_url.rstrip("/")
        self.user = user
        self.password = password
        self.result_format = result_format
        self.warnings: list = []
        # monotonic 0..1 progress of the last execute() (the protocol
        # stats blob's qstats stage-walk estimate)
        self.last_progress: float = 0.0
        # session properties accumulated from SET SESSION statements,
        # replayed on every request via X-Trino-Session (the reference
        # client's session accumulation, StatementClientV1)
        self.session_properties: dict[str, object] = {}
        # prepared statements accumulated from PREPARE/DEALLOCATE,
        # replayed via X-Trino-Prepared-Statement (the reference's
        # addedPreparedStatements round-trip)
        self.prepared_statements: dict[str, str] = {}
        # per-thread persistent HTTP/1.1 connections: one TCP connect
        # (and one server handler thread) per client thread instead of
        # per request — the serving fast path answers a repeated
        # SELECT in a single round trip on an already-open socket
        self._conns: dict[int, http.client.HTTPConnection] = {}
        self._conns_lock = threading.Lock()

    def _new_conn(self) -> http.client.HTTPConnection:
        from presto_tpu_torch.server.httpbase import client_ssl_context
        sp = urlsplit(self.base_url)
        if sp.scheme == "https":
            import ssl
            ctx = client_ssl_context()
            if ctx is None:
                ctx = ssl.create_default_context()
            conn: http.client.HTTPConnection = \
                http.client.HTTPSConnection(
                    sp.hostname, sp.port, timeout=300, context=ctx)
        else:
            conn = http.client.HTTPConnection(sp.hostname, sp.port,
                                              timeout=300)
        conn.connect()
        # request/response pairs ping-pong on this socket: Nagle +
        # delayed ACK would add ~40ms to every exchange
        import socket
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _drop_conn(self, tid: int) -> None:
        with self._conns_lock:
            conn = self._conns.pop(tid, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _headers(self) -> dict:
        headers = {"X-Trino-User": self.user}
        if self.result_format != "json":
            headers["X-Presto-TPU-Result"] = self.result_format
        if self.session_properties:
            from urllib.parse import quote
            # values are URL-encoded so a comma/equals inside a value
            # cannot corrupt the comma-separated header (the reference
            # protocol encodes the same way)
            headers["X-Trino-Session"] = ",".join(
                f"{k}={quote(str(v))}"
                for k, v in self.session_properties.items())
        if self.prepared_statements:
            from urllib.parse import quote
            headers["X-Trino-Prepared-Statement"] = ",".join(
                f"{quote(k)}={quote(v)}"
                for k, v in self.prepared_statements.items())
        if self.password is not None:
            import base64
            cred = base64.b64encode(
                f"{self.user}:{self.password}".encode()).decode()
            headers["Authorization"] = f"Basic {cred}"
        return headers

    def _request(self, method: str, url: str, body: bytes | None = None):
        sp = urlsplit(url)
        path = sp.path + (f"?{sp.query}" if sp.query else "")
        headers = self._headers()
        tid = threading.get_ident()
        resp = None
        for attempt in (0, 1):
            with self._conns_lock:
                conn = self._conns.get(tid)
            if conn is None:
                conn = self._new_conn()
                with self._conns_lock:
                    self._conns[tid] = conn
            try:
                conn.request(method, path, body=body, headers=headers)
            except (http.client.HTTPException, OSError):
                # send-phase failure: the server processed nothing, so
                # a fresh-connection retry is safe for ANY method (the
                # usual cause is the far end closing an idle socket)
                self._drop_conn(tid)
                if attempt:
                    raise
                continue
            try:
                resp = conn.getresponse()
            except (http.client.HTTPException, OSError):
                self._drop_conn(tid)
                # the request reached the wire: only retry methods the
                # server may safely see twice (a POSTed statement could
                # otherwise double-submit)
                if attempt or method not in ("GET", "DELETE"):
                    raise
                continue
            break
        status = resp.status
        data = resp.read()  # always drain: keep-alive needs EOF
        if status >= 400:
            # the connection may hold an unread request body (e.g. a
            # 401 sent before the server read our POST data): never
            # reuse it after an error response
            self._drop_conn(tid)
        if status == 429:
            # overload shedding answers 429 with the QueryResults JSON
            # (QUERY_QUEUE_FULL + Retry-After); surface it as a result
            # so execute() raises the classified QueryFailed. Other
            # statuses (401 auth, 404 ownership) raise like urllib did.
            try:
                return json.loads(data)
            except (ValueError, TypeError):
                pass
        if status >= 400:
            raise urllib.error.HTTPError(url, status, resp.reason,
                                         resp.headers, io.BytesIO(data))
        ctype = resp.headers.get("Content-Type", "")
        if ctype.startswith("application/vnd.presto-tpu"):
            return self._binary_result(data, resp.headers, url)
        return json.loads(data or b"{}")

    def close(self) -> None:
        """Close this client's persistent connections (optional; idle
        server threads also time out on their own)."""
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    def _binary_result(self, body: bytes, headers, url: str) -> dict:
        """An arrow result page -> the SAME QueryResults shape the
        JSON envelope carries: the body's wire bytes decode to rows
        byte-identical to the buffered/JSON path, state/token/columns
        come off the response headers."""
        from presto_tpu_torch.server.results import rows_from_wire_page

        out: dict = {"stats": {
            "state": headers.get("X-PrestoTpu-State", "RUNNING")}}
        cols = headers.get("X-PrestoTpu-Columns")
        if cols:
            out["columns"] = json.loads(cols)
        if body:
            out["data"] = rows_from_wire_page(body)
        if headers.get("X-PrestoTpu-Complete") != "1":
            nxt = headers.get("X-PrestoTpu-Next-Token", "0")
            out["nextUri"] = re.sub(r"/\d+$", f"/{nxt}", url)
        return out

    def execute(self, sql: str, poll_interval: float = 0.02,
                on_progress=None):
        """Run SQL; returns (columns, rows). Blocks until the result
        stream drains. Server-side diagnostics accumulate in
        ``self.warnings`` (reference StatementClientV1
        currentStatusInfo().getWarnings). ``on_progress`` (when given)
        is called with the protocol stats blob's monotonic 0..1
        ``progress`` estimate whenever it advances; the latest value
        is also kept on ``self.last_progress``."""
        out = self._request("POST", f"{self.base_url}/v1/statement",
                            sql.encode())
        columns = None
        rows: list[list] = []
        self.warnings = []
        self.last_progress = 0.0
        while True:
            progress = out.get("stats", {}).get("progress")
            if progress is not None \
                    and progress > self.last_progress:
                self.last_progress = float(progress)
                if on_progress is not None:
                    on_progress(self.last_progress)
            if "error" in out and out["error"]:
                raise QueryFailed(out["error"].get("message", "failed"),
                                  out["error"].get("errorName"))
            if out.get("columns"):
                columns = out["columns"]
            if out.get("setSession"):
                self.session_properties.update(out["setSession"])
            if out.get("addedPreparedStatements"):
                self.prepared_statements.update(
                    out["addedPreparedStatements"])
            for name in out.get("deallocatedPreparedStatements") or ():
                self.prepared_statements.pop(name, None)
            if out.get("warnings"):
                self.warnings = out["warnings"]
            rows.extend(out.get("data", []))
            next_uri = out.get("nextUri")
            if next_uri is None:
                return columns or [], rows
            state = out.get("stats", {}).get("state")
            if state in ("QUEUED", "RUNNING") and not out.get("data"):
                # only an EMPTY poll sleeps: streamed pages arriving
                # while RUNNING drain back-to-back at wire speed
                time.sleep(poll_interval)
            out = self._request("GET", next_uri)

    def submit(self, sql: str) -> tuple[str, dict]:
        """Fire-and-poll entry: POST the statement, return
        (query_id, first response) without waiting for completion."""
        out = self._request("POST", f"{self.base_url}/v1/statement",
                            sql.encode())
        return out["id"], out

    def query_state(self, query_id: str) -> str:
        info = self._request("GET",
                             f"{self.base_url}/v1/query/{query_id}")
        return info.get("state", "UNKNOWN")

    def cancel(self, query_id: str) -> None:
        self._request(
            "DELETE",
            f"{self.base_url}/v1/statement/executing/{query_id}/0")

    def server_info(self) -> dict:
        return self._request("GET", f"{self.base_url}/v1/info")

    def queries(self) -> list[dict]:
        return self._request("GET", f"{self.base_url}/v1/query")
