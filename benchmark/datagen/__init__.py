"""Seeded data generators of the benchmark's configurations.

Each module is a copy of the port's numpy generator
(``presto_tpu_torch/connectors/tpch.py`` and ``tpcds.py`` at commit
5551729), rewritten to import nothing of the port and to make only the
columns a configuration names, with the port's draws in the port's
order. TPC-H's columns equal the port's for the same scale and seed;
TPC-DS's tables take the configuration's row counts and the spec's
dates instead of the port's, so they differ from the port's.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np


@dataclasses.dataclass
class Strings:
    """A string column as int32 codes into a sorted dictionary (code
    order is collation order)."""

    codes: np.ndarray
    dictionary: np.ndarray

    def __len__(self) -> int:
        return int(self.codes.shape[0])


def pick(vocab, idx: np.ndarray) -> Strings:
    """Rows chosen from a small vocabulary, as codes into its sorted
    dictionary."""
    sorted_dict, inv = np.unique(np.array(vocab, dtype="U64"),
                                 return_inverse=True)
    return Strings(inv.astype(np.int32)[idx], sorted_dict.astype(object))


def encode(values: np.ndarray) -> Strings:
    """Dictionary-encode an array of strings."""
    sorted_dict, inv = np.unique(np.asarray(values).astype("U"),
                                 return_inverse=True)
    return Strings(inv.astype(np.int32).reshape(-1),
                   sorted_dict.astype(object))


def days(s: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return int((np.datetime64(s) - np.datetime64("1970-01-01"))
               .astype(int))


def make_all(makers: dict) -> dict:
    """Run independent table makers (name -> callable) on a few threads:
    numpy lets go of the interpreter while it draws and sorts."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {name: pool.submit(fn) for name, fn in makers.items()}
        return {name: f.result() for name, f in futures.items()}
