"""The benchmark's harness: the parts that every cell shares.

``cell`` finds a cell's configuration, traffic mix, queries and metric
readers by name; ``traffic`` turns a mix into a query stream;
``program`` hands the generated arrays to the port and builds its
engine; ``record`` wraps the port's kernel entries, spans and profiler
in a traced run; ``judge`` decides ``correct``.
"""
