"""BENCHMARK.json against the benchmark's contract: names, units and
limits, and every configuration, traffic mix, driver and metric it names
found as a file of its own."""

import json
import os
import re

import pytest

from h100bench import harness

ROOT = harness.ROOT
BENCH = harness.bench_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _names():
    out = [("config", c["name"]) for c in BENCH["configs"]]
    out += [("cell", w["name"]) for w in BENCH["workloads"]]
    out += [("traffic", w["traffic"]) for w in BENCH["workloads"]]
    out += [("metric", m["name"]) for m in BENCH["end_to_end"]
            + BENCH["per_layer"]]
    out += [("reduced", k) for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("kind,name", _names())
def test_name_uses_allowed_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert os.path.isfile(os.path.join(ROOT, "h100bench", "metrics",
                                       metric["name"] + ".py"))
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["layer"] and "\n" not in metric["layer"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    size = os.path.getsize(os.path.join(ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    assert len(cell["why"]) <= 200 and cell["chips"] in (1, 4)
    config = harness.find(BENCH["configs"], cell["config"], "config")
    assert config["file"].startswith("h100bench/")
    assert os.path.isfile(os.path.join(ROOT, config["file"]))
    traffic = harness.load_json(os.path.join(
        ROOT, "h100bench", "traffic", cell["traffic"] + ".json"))
    assert os.path.isfile(os.path.join(ROOT, "h100bench", "drivers",
                                       traffic["driver"] + ".py"))
    e2e = harness.cell_metrics(BENCH, cell["name"], False)
    layer = harness.cell_metrics(BENCH, cell["name"], True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer


def test_configuration_file_is_what_runs():
    """The configuration file holds the tree the program is built from,
    as the shipped cfg file builds it (what is reduced is cut from the
    source, not from that file)."""
    from objgan_tpu_torch.core.config import Config, cfg_from_file

    for c in BENCH["configs"]:
        doc = harness.load_json(os.path.join(ROOT, c["file"]))
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
        built = Config().merged(doc["config"])
        shipped = cfg_from_file(os.path.join(ROOT, "cfg",
                                             c["name"] + ".yml"))
        for group in ("TREE", "GAN", "TEXT", "OBJ"):
            assert getattr(built, group) == getattr(shipped, group)
        assert built.TRAIN.BATCH_SIZE == shipped.TRAIN.BATCH_SIZE
        assert built.DTYPE == shipped.DTYPE


def test_command_and_paths():
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    json.dumps(BENCH)
