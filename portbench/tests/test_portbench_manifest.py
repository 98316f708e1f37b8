"""BENCHMARK.json against the contract's rules, and every file it names in place."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
TEXT = re.compile(r"[^\n\t]{1,200}\Z")
PATH = re.compile(r"[A-Za-z0-9_./\-]{1,200}\Z")
METRIC_KEYS = {"name", "unit", "better", "source"}


def cells():
    return {w["name"]: w for w in MANIFEST["workloads"]}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(TEXT.match(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    full_check = 2 + 14 * 24
    assert full_check * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_fields(group):
    for m in MANIFEST[group]:
        extra = {"bound"} if group == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == METRIC_KEYS | extra, m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert all(w in cells() for w in m.get("workloads", cells()))
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0 < m["bound"] <= 0.25 and (m["bound"] >= 0.01)
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert TEXT.match(m["layer"])


def test_every_moves_names_an_end_to_end_metric_of_each_listed_cell():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells()):
            assert harness._applies(e2e[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("cell", sorted(cells()))
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if harness._applies(m, cell)]
    per_layer = [m for m in MANIFEST["per_layer"] if harness._applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    w = cells()[cell]
    assert w["chips"] == 1 and TEXT.match(w["why"]) and len(w["why"]) <= 200
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])


@pytest.mark.parametrize("cell", sorted(cells()))
def test_each_cell_finds_its_files(cell):
    loaded = harness.load_cell(cell)
    assert (harness.HERE / "drivers" / f"{loaded.traffic['driver']}.py").exists()
    for m in loaded.per_layer:
        assert callable(harness.reader(m["name"]))
    assert loaded.limits


def test_configs_name_their_files_and_list_their_cuts():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("portbench/")
        assert TEXT.match(c["source"]) and len(c["reduced"]) <= 16
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and "assumed" in body


def test_a_cell_is_found_by_its_name_alone(tmp_path):
    """A traffic mix, a configuration or a metric is files plus a manifest entry."""
    names = {p.stem for p in (harness.HERE / "traffic").glob("*.json")}
    assert {w["traffic"] for w in MANIFEST["workloads"]} <= names
    readers = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert {m["name"] for m in MANIFEST["per_layer"]} <= readers
