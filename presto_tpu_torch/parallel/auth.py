"""Shared-secret authentication for internal worker RPC.

The reference signs every internal request with a JWT derived from
``internal-communication.shared-secret``
(server/InternalAuthenticationManager + InternalCommunicationConfig.java:34,49).
Here: an HMAC-SHA256 bearer over a timestamp, valid for a bounded window
(replay within the window is inside the cluster trust model, as with the
reference's JWT expiry). The secret comes from the
PRESTO_TPU_INTERNAL_SECRET environment variable or explicit wiring; with
no secret configured, auth is disabled (single-machine dev mode).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time

HEADER = "X-Presto-Internal-Bearer"
MAX_SKEW_S = 300


def default_secret() -> str | None:
    return os.environ.get("PRESTO_TPU_INTERNAL_SECRET") or None


def make_token(secret: str, now: float | None = None) -> str:
    ts = str(int(now if now is not None else time.time()))
    sig = hmac.new(secret.encode(), ts.encode(),
                   hashlib.sha256).hexdigest()
    return f"{ts}.{sig}"


def check_token(secret: str, token: str | None,
                now: float | None = None) -> bool:
    if not token or "." not in token:
        return False
    ts, _, sig = token.partition(".")
    if not ts.isdigit():
        return False
    want = hmac.new(secret.encode(), ts.encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, sig):
        return False
    age = abs((now if now is not None else time.time()) - int(ts))
    return age <= MAX_SKEW_S
