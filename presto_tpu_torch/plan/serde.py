"""Versioned plan-IR serialization (plan tree <-> JSON-able dicts).

The wire format for shipping plan fragments to workers — the analog of
the reference's JSON-serialized PlanFragment inside TaskUpdateRequest
(server/remotetask/HttpRemoteTask.java:533, sql/planner/PlanFragment
Jackson bindings). Every plan node, expression, aggregate call, and
data type is a dataclass; the codec is field-driven with a class
registry, so new node types serialize by registration alone.
"""

from __future__ import annotations

import dataclasses
import enum

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.aggregates import AggCall
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.sql import ast as A

VERSION = 1

_CLASSES: dict[str, type] = {}


def _register(*classes):
    for c in classes:
        _CLASSES[c.__name__] = c


_register(
    # plan nodes
    N.TableScan, N.Values, N.Filter, N.Project, N.Aggregate, N.Join,
    N.MultiJoin, N.SemiJoin, N.CrossJoin, N.Union, N.Unnest, N.Sort,
    N.TopN, N.Limit,
    N.Distinct, N.MarkDistinct, N.Window, N.MatchRecognize, N.Exchange,
    N.Output,
    # plan helpers
    N.Ordering, N.WindowCall, AggCall,
    # the parsed row-pattern AST a MatchRecognize node carries
    A.PatVar, A.PatConcat, A.PatAlt, A.PatQuant,
    # expressions
    ir.ColumnRef, ir.Literal, ir.Call, ir.Cast, ir.CaseWhen, ir.InList,
    ir.IsNull,
)

_ENUMS: dict[str, type] = {e.__name__: e for e in
                           (N.AggStep, N.JoinType, N.ExchangeType)}


def to_dict(obj):
    """Encode a plan/expression tree into JSON-able values."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, T.DataType):
        # data types round-trip through their SQL rendering (the
        # subclasses have custom no-arg constructors)
        return {"$t": str(obj)}
    if isinstance(obj, enum.Enum):
        return {"$enum": type(obj).__name__, "value": obj.value}
    if isinstance(obj, (list, tuple)):
        return {"$seq": "tuple" if isinstance(obj, tuple) else "list",
                "items": [to_dict(v) for v in obj]}
    if isinstance(obj, frozenset):
        return {"$seq": "frozenset",
                "items": sorted((to_dict(v) for v in obj), key=repr)}
    if isinstance(obj, dict):
        return {"$map": [[to_dict(k), to_dict(v)]
                         for k, v in obj.items()]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _CLASSES:
            raise TypeError(f"unregistered plan class: {name}")
        return {"$c": name,
                "fields": {f.name: to_dict(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def from_dict(d):
    if d is None or isinstance(d, (bool, int, float, str)):
        return d
    if "$t" in d:
        return T.parse_type(d["$t"])
    if "$enum" in d:
        return _ENUMS[d["$enum"]](d["value"])
    if "$seq" in d:
        items = [from_dict(v) for v in d["items"]]
        if d["$seq"] == "tuple":
            return tuple(items)
        if d["$seq"] == "frozenset":
            return frozenset(items)
        return items
    if "$map" in d:
        return {from_dict(k): from_dict(v) for k, v in d["$map"]}
    if "$c" in d:
        cls = _CLASSES[d["$c"]]
        return cls(**{k: from_dict(v) for k, v in d["fields"].items()})
    raise TypeError(f"cannot deserialize {d!r}")


def fragment_to_dict(plan: N.PlanNode) -> dict:
    return {"version": VERSION, "root": to_dict(plan)}


def fragment_from_dict(d: dict) -> N.PlanNode:
    if d.get("version") != VERSION:
        raise ValueError(
            f"plan fragment version {d.get('version')} != {VERSION}")
    return from_dict(d["root"])
