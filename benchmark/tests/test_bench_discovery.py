"""The harness finds a configuration, a traffic mix, a query and a
metric that a later change adds as new files: here a copy of the
benchmark in a temporary directory, with one more of each."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

from conftest import BENCH, CHECKOUT


def test_new_files_are_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "tpch-sf10.json").read_text())
    config.update(name="tpch-sf1", scale=1)
    (bench / "configs" / "tpch-sf1.json").write_text(json.dumps(config))
    (bench / "traffic" / "tpch" / "pair.json").write_text(json.dumps({
        "queries": ["q06", "q99"],
        "params": {"q06": {"date": {"kind": "month", "lo": "1994-01",
                                    "hi": "1994-01"},
                           "discount": {"kind": "choice",
                                        "values": ["0.06"]},
                           "quantity": {"kind": "int", "lo": 24,
                                        "hi": 24}}}}))
    (bench / "reference" / "tpch" / "q99.py").write_text(textwrap.dedent('''
        SQL = "select count(*) from nation"
        COLUMNS = [("c", "int")]
        ORDER = []
        LIMIT = None

        def answer(db, p):
            return [(int(db.col("nation", "n_nationkey").numel()),)]
        '''))
    (bench / "metrics" / "half_setup_s.py").write_text(
        "def read(run):\n    return run.setup_s / 2\n")
    spec["configs"].append({"name": "tpch-sf1", "source": "x",
                            "file": "benchmark/configs/tpch-sf1.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tpch-sf1.pair", "config": "tpch-sf1",
                              "traffic": "pair", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "half_setup_s", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "device", "moves": "setup_s",
                              "workloads": ["tpch-sf1.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    probe = textwrap.dedent(f'''
        import sys
        from pathlib import Path
        sys.path[:0] = [{str(bench)!r}, {str(CHECKOUT)!r}]
        import run as R
        from harness import cell as C, traffic
        cell = C.load(Path({str(tmp_path)!r}), Path({str(bench)!r}),
                      "tpch-sf1.pair")
        assert cell.config["scale"] == 1
        assert [m["name"] for m in cell.per_layer] == ["half_setup_s"]
        s = traffic.Stream(cell.mix, cell.references, 3)
        assert s.query(1)[2] == "select count(*) from nation"
        assert "0.06" in s.query(0)[2]
        run = R.Run(10.0, 1.0, [], 0, None, None)
        print(C.reader("half_setup_s")(run))
        ''')
    done = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "5.0"
