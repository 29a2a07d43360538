"""Host tables as scan inputs: the port of the reference's
``spill._compact`` and ``spill._carrier_scan``
(``presto_tpu/exec/spill.py``) for the paths that finish part of a plan
on the host (MATCH_RECOGNIZE's matches, a variable-length aggregate's
lists) and run the rest of the plan over the result on the device.

A carrier is a TableScan of the segment catalog, so ``collect_scans``
finds it by name after column pruning, beside the plan's connector
scans. Its columns go up through ``hostsync.upload`` once per run and
are not pinned in the engine's column cache (they live for one
query). An ARRAY column of host lists goes up in the padded 2-D layout
with its ``$len`` and ``$emask`` companions; other host values (a
listagg's strings, a map_agg's dicts) cannot feed a plan.
"""

from __future__ import annotations

import itertools

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table, pad_object_lists
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.plan import nodes as N

_NAMES = itertools.count()


def compact_table(tbl: Table) -> Table:
    """The live rows of a host table, its mask dropped."""
    if tbl.mask is None:
        return tbl
    m = np.asarray(tbl.mask)
    cols = {s: Column(c.dtype, np.asarray(c.data)[m],
                      None if c.valid is None else np.asarray(c.valid)[m],
                      c.dictionary)
            for s, c in tbl.columns.items()}
    return Table(cols, int(m.sum()), None)


def carrier_scan(engine, name: str, tbl: Table) -> tuple:
    """(TableScan node, ScanInput) serving the live rows of host table
    ``tbl`` on the engine's device."""
    from presto_tpu_torch.exec.executor import SEGMENT_CATALOG, ScanInput
    tbl = compact_table(tbl)
    types = {s: c.dtype for s, c in tbl.columns.items()}
    node = N.TableScan(SEGMENT_CATALOG, f"{name}{next(_NAMES)}",
                       {s: s for s in types}, types)

    def up(a):
        return HS.upload(np.asarray(a), engine.device, "host-carrier")

    arrays, dicts = {}, {}
    for s, c in tbl.columns.items():
        a = np.asarray(c.data)
        if isinstance(c.dtype, T.ArrayType) and a.dtype == object:
            d2, lens, emask, dictionary = pad_object_lists(
                c.dtype.element, a)
            arrays[s], arrays[f"{s}$len"] = up(d2), up(lens)
            arrays[f"{s}$emask"] = up(emask)
            dicts[s] = dictionary
        elif a.dtype == object:
            raise NotImplementedError(
                f"a {c.dtype} column of host values cannot feed the rest "
                "of a plan")
        else:
            arrays[s] = up(a)
            dicts[s] = c.dictionary
        if c.valid is not None:
            arrays[f"{s}$valid"] = up(c.valid)
    return node, ScanInput(node, arrays, dicts, types, tbl.nrows)
