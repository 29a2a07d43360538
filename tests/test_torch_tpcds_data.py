"""The port's TPC-DS connector makes the reference's data: for the
same (scale, seed), every table's row count, live mask and every
column's type, data, validity and dictionary are identical, byte for
byte, between presto_tpu_torch.connectors.tpcds and
presto_tpu.connectors.tpcds. The generator stands in for weights
here, so this identity carries the reference's state across."""

import numpy as np
import pytest

from presto_tpu.connectors.tpcds import TpcdsConnector as RefTpcds

from presto_tpu_torch.connectors import TpcdsConnector

SCALE = 0.003


@pytest.fixture(scope="module")
def pair():
    return TpcdsConnector(scale=SCALE), RefTpcds(scale=SCALE)


def _same_array(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == object:
        assert a.tolist() == b.tolist(), what
    else:
        assert a.tobytes() == b.tobytes(), what


def test_same_tables_schemas_and_statistics(pair):
    port, ref = pair
    assert port.table_names() == ref.table_names()
    assert len(ref.table_names()) >= 20
    for name in ref.table_names():
        assert ({c: str(t) for c, t in port.table_schema(name).items()}
                == {c: str(t) for c, t in ref.table_schema(name).items()})
        assert port.row_count_estimate(name) == ref.row_count_estimate(name)
        assert port.ndv_estimates(name) == ref.ndv_estimates(name)
        assert port.unique_keys(name) == ref.unique_keys(name)


@pytest.mark.parametrize("seed", [None, 7])
def test_every_column_is_byte_identical(pair, seed):
    port, ref = pair
    if seed is not None:
        port, ref = (TpcdsConnector(scale=SCALE, seed=seed),
                     RefTpcds(scale=SCALE, seed=seed))
    for name in ref.table_names():
        pt, rt = port.table(name), ref.table(name)
        assert pt.nrows == rt.nrows, name
        assert list(pt.columns) == list(rt.columns), name
        _same_array(pt.mask, rt.mask, f"{name} mask")
        for col, rc in rt.columns.items():
            pc = pt.columns[col]
            what = f"{name}.{col}"
            assert str(pc.dtype) == str(rc.dtype), what
            _same_array(pc.data, rc.data, what)
            _same_array(pc.valid, rc.valid, f"{what} valid")
            _same_array(pc.dictionary, rc.dictionary, f"{what} dictionary")
