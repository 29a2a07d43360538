"""One memo of the host's string-dictionary derivations.

A VARCHAR value carries its sorted dictionary on the host
(``expr/compile.Val``), and the string operators derive host arrays
from dictionaries alone:

- ``union``: the sorted union of several dictionaries and each one's
  int32 remap into it (UNION ALL and the grouping sets planned as one,
  CASE / COALESCE / greatest / least / ARRAY over strings);
- ``align``: the int32 mapping of one dictionary's codes into another's
  code space, -1 where a string is absent (string equality, join key
  checks, array membership);
- ``transform``: the sorted dictionary of a string function's results
  and the int32 inverse remap from the old codes (substr, lower, ...).

Each is a pure function of its input dictionaries (and of a transform's
literal parameters), and a dictionary is never written after it is
made, so each is derived once per process and reused by every later
query: a table's dictionary is the same object from one run to the
next. The memo holds host arrays only; the callers upload the remap
and gather by code on every run, as without it.

Keys: a dictionary of at most ``SMALL_DICT`` strings is keyed by its
content (a literal's one-string dictionary is a fresh object on every
run), a larger one by its identity, checked against a weak reference
on every hit; an entry goes when a dictionary it is keyed by is
collected. A hit returns the very arrays of the first derivation, not
writeable, so a derivation keyed by an earlier one's output dictionary
hits too, and so does an ``a.dictionary is b.dictionary`` test
downstream. At most ``MAX_ENTRIES`` entries are kept, least recently
used out first. ``presto_tpu_dictionary_memo_total`` counts lookups by
``kind`` (union, merge, align, transform) and ``result`` (hit, miss).
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Callable, Hashable

import numpy as np

from presto_tpu_torch.obs.metrics import REGISTRY

# a dictionary of at most this many strings is keyed by its content
SMALL_DICT = 64
# entries kept, least recently used out first
MAX_ENTRIES = 64

_LOOKUPS = REGISTRY.counter(
    "presto_tpu_dictionary_memo_total",
    "host string-dictionary derivations looked up in the memo, labeled "
    "kind=union|merge|align|transform and result=hit|miss")


def _freeze(value):
    """``value`` (arrays, nested in tuples) made read-only in place."""
    if isinstance(value, np.ndarray):
        value.flags.writeable = False
    elif isinstance(value, tuple):
        for v in value:
            _freeze(v)
    return value


class _Entry:
    __slots__ = ("refs", "value")

    def __init__(self, refs: tuple, value):
        self.refs = refs  # per input: a weak reference, None = by content
        self.value = value

    def holds(self, dicts) -> bool:
        """Are the identity-keyed inputs still these very objects?"""
        return all(r is None or r() is d for r, d in zip(self.refs, dicts))

    def dead(self) -> bool:
        return any(r is not None and r() is None for r in self.refs)


class DictMemo:
    """The memo: ``derive`` returns the stored value for its key, or
    computes, stores and returns it. Thread-safe; two threads that miss
    on one key at once both compute, and both get the first stored."""

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # keys whose dictionary was collected: weak-reference callbacks
        # append here without the lock (they may run on any thread, in
        # the middle of a locked section), and the next locked section
        # drops what is dead
        self._dead: collections.deque = collections.deque()

    def derive(self, kind: str, name: str, dicts, params: Hashable,
               compute: Callable):
        key = (name, params, tuple(
            ("c", tuple(d.tolist())) if len(d) <= SMALL_DICT
            else ("i", id(d)) for d in dicts))
        with self._lock:
            self._purge()
            entry = self._entries.get(key)
            if entry is not None and entry.holds(dicts):
                self._entries.move_to_end(key)
                value = entry.value
            else:
                value = None
        if value is not None:
            _LOOKUPS.inc(kind=kind, result="hit")
            return value
        _LOOKUPS.inc(kind=kind, result="miss")
        value = _freeze(compute())
        dead = self._dead
        refs = tuple(
            None if len(d) <= SMALL_DICT
            else weakref.ref(d, lambda _r, k=key: dead.append(k))
            for d in dicts)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.holds(dicts):
                value = entry.value  # another thread stored it first
            else:
                self._entries[key] = _Entry(refs, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return value

    def _purge(self) -> None:
        """Drop entries whose dictionary was collected (lock held)."""
        while self._dead:
            key = self._dead.popleft()
            entry = self._entries.get(key)
            if entry is not None and entry.dead():
                del self._entries[key]

    def __len__(self) -> int:
        with self._lock:
            self._purge()
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


MEMO = DictMemo()


# --- the derivations -------------------------------------------------------


def _union(dicts) -> tuple:
    texts = [d.astype("U") for d in dicts]
    union = np.unique(np.concatenate(texts))
    return union.astype(object), tuple(
        np.searchsorted(union, t).astype(np.int32) for t in texts)


def union(dicts, kind: str = "union") -> tuple:
    """(the sorted union of ``dicts`` as an object array, the int32
    remap of each input's codes into it)."""
    dicts = tuple(dicts)
    return MEMO.derive(kind, "union", dicts, (), lambda: _union(dicts))


def _align(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ta = a.astype("U")
    idx = np.searchsorted(b, ta)
    idx = np.clip(idx, 0, max(len(b) - 1, 0))
    ok = (b.astype("U")[idx] == ta) if len(b) else np.zeros(len(a), bool)
    return np.where(ok, idx, -1).astype(np.int32)


def align(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The int32 position of each of ``a``'s strings in the sorted
    ``b``, -1 where ``b`` lacks it."""
    return MEMO.derive("align", "align", (a, b), (), lambda: _align(a, b))


def _transform(d: np.ndarray, fn: Callable) -> tuple:
    new_strings = fn(d.astype("U")).astype(object)
    new_dict, inverse = np.unique(new_strings.astype("U"),
                                  return_inverse=True)
    return new_dict.astype(object), inverse.astype(np.int32)


def transform(d: np.ndarray, fn: Callable[[np.ndarray], np.ndarray],
              key: Hashable | None = None) -> tuple:
    """(the sorted dictionary of ``fn`` over ``d``'s strings, the int32
    inverse remap of ``d``'s codes). ``key`` names ``fn`` with its
    literal parameters; without it nothing is memoized."""
    if key is None:
        return _transform(d, fn)
    return MEMO.derive("transform", "transform", (d,), key,
                       lambda: _transform(d, fn))
