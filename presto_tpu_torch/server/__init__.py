"""Coordinator server: REST client protocol + cluster endpoints.

Analog of the reference's server layer (core/trino-main server/ +
dispatcher/): the client protocol keeps Trino's contract — POST
/v1/statement returns a queued query with a ``nextUri``; the client polls
nextUri until FINISHED, receiving column metadata and data pages
(dispatcher/QueuedStatementResource.java:94,
server/protocol/ExecutingStatementResource.java,
client/trino-client/.../StatementClientV1.java:323).
"""

from presto_tpu_torch.server.server import CoordinatorServer  # noqa: F401
