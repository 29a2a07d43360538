"""Interactive SQL shell.

Analog of the reference's trino-cli (client/trino-cli/.../Trino.java:40,
Console.java:82): a readline REPL that talks either to a coordinator over
the REST protocol (--server) or to an in-process engine (default, with
the tpch tiny catalog loaded), rendering aligned result tables. The
in-process engine runs on the card; ``--device cpu`` runs it on the CPU.

Usage:
  python -m presto_tpu_torch.cli                 # in-process, tpch tiny
  python -m presto_tpu_torch.cli --device cpu
  python -m presto_tpu_torch.cli --scale 1.0
  python -m presto_tpu_torch.cli --server http://localhost:8080
  python -m presto_tpu_torch.cli -e "select 1"   # one-shot
"""

from __future__ import annotations

import argparse
import sys
import time


def _render(columns: list[str], rows: list) -> str:
    cells = [[("NULL" if v is None else str(v)) for v in row]
             for row in rows]
    widths = [len(c) for c in columns]
    for row in cells:
        for i, v in enumerate(row):
            widths[i] = max(widths[i], len(v))
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(c.ljust(w) for c, w in zip(columns, widths)), sep]
    for row in cells:
        out.append(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
    return "\n".join(out)


class _InProcessBackend:
    def __init__(self, scale: float, device=None):
        from presto_tpu_torch import Engine
        from presto_tpu_torch.connectors.memory import MemoryConnector
        from presto_tpu_torch.connectors.tpch import TpchConnector
        self.engine = Engine(device=device)
        self.engine.register_catalog("tpch", TpchConnector(scale=scale))
        self.engine.register_catalog("memory", MemoryConnector())

    def execute(self, sql: str):
        from presto_tpu_torch.sql import ast as A
        from presto_tpu_torch.sql.parser import parse_statement
        stmt = parse_statement(sql)
        if isinstance(stmt, A.QueryStatement):
            plan, _ = self.engine.plan_sql(sql)
            names = plan.names
            return names, self.engine.execute(sql)
        rows = self.engine.execute(sql)
        width = len(rows[0]) if rows else 1
        return [f"_col{i}" for i in range(width)], rows


class _RemoteBackend:
    def __init__(self, url: str, user: str):
        from presto_tpu_torch.client import Client
        self.client = Client(url, user)

    def execute(self, sql: str):
        # live progress on the poll loop (the coordinator's monotonic
        # qstats stage-walk estimate), drawn on stderr and erased when
        # the result lands so piped stdout stays clean
        shown = [False]

        def on_progress(p: float) -> None:
            if not sys.stderr.isatty():
                return
            filled = int(round(20 * p))
            sys.stderr.write(
                f"\r[{'#' * filled}{'.' * (20 - filled)}] "
                f"{p * 100:3.0f}%")
            sys.stderr.flush()
            shown[0] = True

        try:
            columns, rows = self.client.execute(
                sql, on_progress=on_progress)
        finally:
            if shown[0]:
                sys.stderr.write("\r" + " " * 28 + "\r")
                sys.stderr.flush()
        return [c["name"] for c in columns], rows


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="presto-tpu")
    p.add_argument("--server", help="coordinator URL (default in-process)")
    p.add_argument("--user", default="presto")
    p.add_argument("--scale", type=float, default=0.01,
                   help="tpch scale for in-process mode")
    p.add_argument("--device", default=None,
                   help="in-process engine device (default the card)")
    p.add_argument("-e", "--execute", help="run one statement and exit")
    args = p.parse_args(argv)

    backend = (_RemoteBackend(args.server, args.user) if args.server
               else _InProcessBackend(args.scale, args.device))

    def run_one(sql: str) -> None:
        t0 = time.perf_counter()
        try:
            columns, rows = backend.execute(sql)
        except Exception as e:  # noqa: BLE001
            print(f"Query failed: {e}", file=sys.stderr)
            return
        wall = time.perf_counter() - t0
        print(_render(columns, rows))
        print(f"({len(rows)} rows, {wall:.2f}s)")

    if args.execute:
        run_one(args.execute)
        return 0

    try:
        import readline  # noqa: F401 - line editing side effect
    except ImportError:
        pass
    print("presto-tpu CLI — \\q to quit")
    buf: list[str] = []
    while True:
        try:
            prompt = "presto> " if not buf else "     -> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if line.strip() in ("\\q", "quit", "exit"):
            return 0
        if not line.strip():
            continue
        buf.append(line)
        if line.rstrip().endswith(";"):
            sql = "\n".join(buf).rstrip().rstrip(";")
            buf = []
            run_one(sql)


if __name__ == "__main__":
    sys.exit(main())
