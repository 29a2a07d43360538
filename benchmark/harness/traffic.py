"""One general generator: a traffic mix's file of parameters in, a
query stream out.

A mix (``traffic/<suite>/<mix>.json``) names its queries in loop order
and, per query, how to draw each literal of its SQL template
(``{name}`` in the reference's ``SQL``), and nothing else (``KEYS``). Position ``i`` of the stream
runs query ``queries[i % len(queries)]`` with literals drawn from
``(seed, i)`` alone, so a seed fixes the whole stream and a run that
gets further only adds positions. Kinds of literal:

- ``{"kind": "int", "lo": 60, "hi": 120}``: a whole number, both ends in;
- ``{"kind": "choice", "values": [...]}``: one of the values;
- ``{"kind": "date", "lo": "1995-03-01", "hi": "1995-03-31"}``: a day;
- ``{"kind": "month", "lo": "1993-02", "hi": "1995-01", "step": 1}``:
  the first day of a month, every ``step`` months from ``lo``;
- ``{"kind": "decimal", "lo": "0.02", "hi": "0.09", "step": "0.01"}``;
- ``{"kind": "distinct", "values": [...], "names": ["a", "b"]}``: as
  many different values as names, one to each name.
"""

from __future__ import annotations

import decimal

import numpy as np

WARM = 1 << 62  # the warm-up's draws lie past any position a run reaches
# what a mix may say: one client in a closed loop through
# ``Engine.execute`` is all this generator and ``run.py`` drive, so a
# mix that asks for more (clients, think time, another path) is refused
KEYS = {"why", "queries", "params"}


class Stream:
    def __init__(self, mix: dict, references: dict, seed: int):
        unknown = sorted(set(mix) - KEYS)
        if unknown:
            raise ValueError(f"mix keys this harness does not implement: "
                             f"{unknown} (it knows {sorted(KEYS)})")
        self.queries = list(mix["queries"])
        self.params = mix.get("params", {})
        self.references = references
        self.seed = int(seed) % (1 << 63)

    def query(self, i: int) -> tuple[str, dict, str]:
        """(query name, literals, SQL) at position ``i``."""
        name = self.queries[i % len(self.queries)]
        rng = np.random.default_rng([self.seed, i])
        params = {}
        for pname, spec in self.params.get(name, {}).items():
            params.update(draw(rng, pname, spec))
        return name, params, render(self.references[name].SQL, params)

    def warm(self) -> list[tuple[str, dict, str]]:
        """One query of each name, literals drawn apart from the run's."""
        out = []
        for j in range(len(self.queries)):
            name, params, sql = self.query(WARM + j)
            out.append((name, params, sql))
        return out


def render(template: str, params: dict) -> str:
    sql = template
    for k, v in params.items():
        sql = sql.replace("{" + k + "}", str(v))
    if "{" in sql:
        raise ValueError(f"a literal of the template is not drawn: {sql}")
    return sql


def draw(rng: np.random.Generator, name: str, spec: dict) -> dict:
    kind = spec["kind"]
    if kind == "int":
        return {name: int(rng.integers(spec["lo"], spec["hi"] + 1))}
    if kind == "choice":
        return {name: spec["values"][int(rng.integers(len(spec["values"])))]}
    if kind == "date":
        lo, hi = (np.datetime64(spec[k], "D") for k in ("lo", "hi"))
        span = int((hi - lo).astype(int))
        return {name: str(lo + np.timedelta64(
            int(rng.integers(0, span + 1)), "D"))}
    if kind == "month":
        lo, hi = (np.datetime64(spec[k], "M") for k in ("lo", "hi"))
        step = int(spec.get("step", 1))
        count = int((hi - lo).astype(int)) // step + 1
        m = lo + np.timedelta64(step * int(rng.integers(0, count)), "M")
        return {name: str(m.astype("datetime64[D]"))}
    if kind == "decimal":
        lo, hi, step = (decimal.Decimal(spec[k]) for k in ("lo", "hi",
                                                             "step"))
        count = int((hi - lo) / step) + 1
        return {name: str(lo + step * int(rng.integers(0, count)))}
    if kind == "distinct":
        picks = rng.choice(len(spec["values"]), size=len(spec["names"]),
                           replace=False)
        return {n: spec["values"][int(p)]
                for n, p in zip(spec["names"], picks)}
    raise ValueError(f"literal {name}: unknown kind {kind!r}")
