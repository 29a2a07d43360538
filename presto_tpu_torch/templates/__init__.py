"""Parameterized plan templates: literal variants of one query shape
share a program-cache entry and its remembered capacities.

The port of ``presto_tpu/templates/``: the hoisting analysis
(analysis.py), the parameter binding (runtime.py), the shape key
(shapes.py) and the PREPARE / EXECUTE ... USING surface (prepared.py).
``exec/executor.prepare_plan`` keys the program cache and the
capacity memory on the template's fingerprint, so ``Q18 ... having
sum(l_quantity) > 312`` starts from the capacities that ``> 300``
learned.

Session properties: ``plan_templates`` (default on) and
``template_shape_bucketing`` (row counts enter the key as pow2
buckets, default on).
"""

from __future__ import annotations

from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.templates.analysis import (  # noqa: F401
    HOISTABLE_CALL_FNS, STRING_HOISTABLE_FNS, ParamSpec, Template,
    parameterize)
from presto_tpu_torch.templates.shapes import scan_shape_key  # noqa: F401

_TPL_HITS = REGISTRY.counter(
    "presto_tpu_template_cache_hits_total",
    "templated program-cache lookups that found an entry (a literal "
    "variant reused another variant's program and capacities)")
_TPL_MISSES = REGISTRY.counter(
    "presto_tpu_template_cache_misses_total",
    "templated program-cache lookups that found no entry")
_TPL_PARAMS = REGISTRY.gauge(
    "presto_tpu_template_params_hoisted",
    "literals hoisted into the parameter vector of the most recent "
    "templated program")


def enabled(session) -> bool:
    return bool(session.get("plan_templates"))


def shape_bucketing(session) -> bool:
    return bool(session.get("template_shape_bucketing"))


def note_lookup(hit: bool, params: int) -> None:
    """Record one templated program-cache lookup."""
    _TPL_PARAMS.set(params)
    if hit:
        _TPL_HITS.inc()
    else:
        _TPL_MISSES.inc()
