"""The values of a plan template's parameters while its plan runs.

The port of ``presto_tpu/templates/runtime.py``. A parameterized plan
(templates/analysis.py) carries ``ir.Parameter`` leaves where it had
hoistable literals. While the interpreter walks it, :func:`active`
installs the query's parameter values, and ``expr/compile.py``
compiles each Parameter exactly as the literal it replaced: the value
is read on the host from the active binding and goes up like any
literal. So a templated run makes the same uploads, host syncs and
rows as an untemplated one; the template is the program cache's key,
not a traced argument.

:func:`physical_value` and :func:`bind_values` give the reference's
physical encoding of a parameter (a VARCHAR parameter as its code in
the dictionary of the column it is compared against, -1 when absent).

State is per thread (``threading.local``).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np

from presto_tpu_torch import types as T

_TLS = threading.local()


class TemplateError(RuntimeError):
    """A parameterized plan ran without a binding: an engine bug,
    never a user error."""


@contextlib.contextmanager
def active(values: list, dictionaries: dict | None = None):
    """Install a template's parameter values (in parameter order) while
    its plan runs: host values, or under a batch binding
    (exec/batch.py) each parameter's physical value as a tensor that
    the vmap maps, a VARCHAR parameter's code being into
    ``dictionaries[index]``."""
    prev = (getattr(_TLS, "values", None),
            getattr(_TLS, "dictionaries", None))
    _TLS.values = list(values)
    _TLS.dictionaries = dictionaries or {}
    try:
        yield
    finally:
        _TLS.values, _TLS.dictionaries = prev


def current_dictionary(index: int):
    """The dictionary a batch-bound VARCHAR parameter's codes index."""
    return (getattr(_TLS, "dictionaries", None) or {}).get(index)


def current_value(index: int):
    """The host value of parameter ``index`` of the active binding."""
    values = getattr(_TLS, "values", None)
    if values is None:
        raise TemplateError(
            "parameterized plan run without a parameter binding")
    return values[index]


def _lit_code(dictionary: np.ndarray, s: str) -> int:
    """Code of a string in a sorted dictionary, or -1 if absent."""
    i = int(np.searchsorted(dictionary, s))
    if i < len(dictionary) and dictionary[i] == s:
        return i
    return -1


def physical_value(dtype, value, dictionary=None) -> np.ndarray:
    """Host physical encoding of one parameter value, as
    ``ExprCompiler._c_literal`` encodes the same literal."""
    if isinstance(dtype, T.VarcharType):
        if dictionary is None or value is None:
            return np.int32(-1)  # matches no code
        return np.int32(_lit_code(dictionary, str(value)))
    if isinstance(dtype, T.DecimalType) and dtype.is_long:
        from presto_tpu_torch.expr.compile import _lit128_np
        return _lit128_np(int(value))
    return np.asarray(value, dtype=dtype.physical_dtype)


def bind_values(specs, bindings: dict | None) -> list:
    """Physical values of a template's ordered parameters
    (templates/analysis.ParamSpec); ``bindings`` maps a VARCHAR
    parameter's index to its column's dictionary (absent: code -1)."""
    bindings = bindings or {}
    return [physical_value(s.dtype, s.value, bindings.get(i))
            for i, s in enumerate(specs)]
