"""The server tier's shared HTTP scaffolding (``httpbase``), which the
cluster's workers serve with. The coordinator server, the protocol
client and the rest of the reference's ``server/`` are not in the port
yet."""
