"""Every `BENCHMARK.json` entry loads and finds its files by name, and the
file keeps to the shape the benchmark's runner reads."""

import json
import re
from pathlib import Path

import pytest

from portbench.harness import cell as C
from portbench.reference.stereo import layer_table

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_shape():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in BENCH[k]}) == len(BENCH[k])
        for m in BENCH[k]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_entries_keep_their_limits():
    """One-line texts of 1 to 200 characters; a (configuration, traffic)
    pair once; a configuration file each; 1 or 4 chips."""
    texts = [e["why"] for k in ("configs", "workloads") for e in BENCH[k]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    texts += [c["source"] for c in BENCH["configs"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert {w["config"] for w in BENCH["workloads"]} == \
        {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = C.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        reader = C.metric_reader(m["name"])
        assert callable(reader.read)
    drive = C.kind_module(cell.traffic["kind"])
    assert callable(drive.inputs) and callable(drive.drive)
    assert cell.limits["numbers"]
    for entry in cell.limits["numbers"].values():
        assert entry["limit"] > 0


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = ROOT / conf["file"]
    assert path.is_relative_to(ROOT / "portbench")
    config = json.loads(path.read_text())
    assert config["name"] == conf["name"]
    assert config["source"] == conf["source"]
    assert config["reduced"] == conf["reduced"] == []
    assert layer_table(config)
    from portbench.harness import port
    port.port_spec(config)  # equal to the program's published spec


def test_every_metric_file_is_used():
    used = {C.metric_file(m["name"]) for m in BENCH["per_layer"]}
    files = set((ROOT / "portbench" / "metrics").glob("*.py"))
    assert files == used


def test_traffic_and_limits_files_are_used():
    traffic = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (ROOT / "portbench" / "traffic")
            .glob("*.json")} == traffic
    kinds = {C.load_cell(n).traffic["kind"] for n in CELLS}
    assert {p.stem for p in (ROOT / "portbench" / "kinds").glob("*.py")
            if p.stem != "__init__"} == kinds
    assert {p.stem for p in (ROOT / "portbench" / "limits")
            .glob("*.json")} == set(CELLS)
