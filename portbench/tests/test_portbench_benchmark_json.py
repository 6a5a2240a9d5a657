"""BENCHMARK.json keeps the contract's form, and every name it gives is
found as a file."""

import json
import os
import re

import pytest

from _util import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert "\t" not in w["why"] and "\n" not in w["why"]
        assert len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len(json.dumps(b)) <= 64 * 1024


def test_per_layer_metrics_move_a_metric_their_cells_report():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= e2e[m["moves"]]
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for cell in cells:
        reported = [n for n, ws in e2e.items() if cell in ws]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])


@pytest.mark.parametrize("held_out", [False, True])
def test_every_name_is_a_file(held_out):
    from portbench import core
    b = core.read_bench(ROOT, held_out=held_out)
    drivers = set()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        drivers.add(cfg["driver"])
    for d in drivers:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "drivers",
                                           d + ".py"))
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic",
                                           w["traffic"] + ".json"))
        with open(os.path.join(ROOT, "portbench", "cells",
                               w["name"] + ".json")) as fh:
            assert set(json.load(fh)["limits"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_a_full_check_fits_the_time_limit():
    b = _bench()
    runs = 2 + 14 * 24
    allowed = runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert allowed <= 43200
