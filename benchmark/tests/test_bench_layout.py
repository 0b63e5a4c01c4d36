"""BENCHMARK.json against the contract's shape, and every name in it found
as a file: configurations, traffic mixes, metric readers, work counts, and
each session and volume generator that is not built in."""
import json
import re

import pytest

from tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_is_found_and_names_itself(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and all(NAME.match(k) for k in conf["reduced"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert conf["file"].startswith("benchmark/configs/")
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    kind = cfg["volume"]["kind"]
    assert kind == "turbulence" or (ROOT / "benchmark" / "generators" / f"{kind}.py").is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_mix_and_reports_enough(cell):
    from vrbench import harness, traffic

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    render = mix["render"]
    assert render in traffic.SESSIONS or (ROOT / "benchmark" / "sessions"
                                          / f"{render}.py").is_file()
    e2e = harness.cell_metrics(BENCH, cell, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(BENCH, cell, trace=True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader_and_a_sound_entry(metric):
    from vrbench import harness

    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for cell in metric.get("workloads", []):
            reported = harness.cell_metrics(BENCH, harness.find_cell(BENCH, cell), trace=False)
            assert metric["moves"] in {m["name"] for m in reported}
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_every_mix_and_metric_has_its_file():
    """Every mix a cell names and every metric has its file."""
    used = {w["traffic"] for w in BENCH["workloads"]}
    mixes = {p.stem for p in (ROOT / "benchmark" / "traffic").glob("*.json")}
    assert used <= mixes
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert metrics <= files
