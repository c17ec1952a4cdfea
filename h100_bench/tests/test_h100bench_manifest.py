"""BENCHMARK.json against the rules its format keeps, and the discovery of
every configuration, traffic mix, driver and metric by name."""

import json
import re
import subprocess
import sys

import pytest

from h100_bench import harness

ROOT = harness.ROOT
MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    paths = MANIFEST["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


def test_check_fits_its_time():
    """2 + 14 x 24 runs at run_seconds + 60 s, 2 x 90 s a cell to compile
    and 1,200 s spare fit into 43,200 s, with the full 24 cells."""
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and not any(
                w in key for w in WIDTH_WORDS), key
        json.loads((ROOT / c["file"]).read_text())


def test_workloads():
    names = [w["name"] for w in MANIFEST["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)


def _metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_metrics():
    names = [m["name"] for m in _metrics()]
    assert len(names) == len(set(names))
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
    for m in _metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = {m["name"] for m in harness.end_to_end_metrics(MANIFEST, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.per_layer_metrics(MANIFEST, cell)
        assert layer and all(m["moves"] in reported for m in layer)


def test_shares_of_a_peak_are_named_so():
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline") or ".".join(m["name"].split(".")[:1]).endswith(
                "_roofline"):
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_is_found_by_name(cell):
    entry, config, traffic = harness.cell_entries(MANIFEST, cell)
    assert entry["name"] == cell
    driver = harness.BENCH_DIR / "drivers" / f"{traffic['driver']}.py"
    assert driver.exists()
    module = harness.load_module(driver, f"test_driver_{traffic['driver']}")
    for method in ("setup", "request", "release", "check"):
        assert callable(getattr(module.Driver, method))
    assert isinstance(config, dict) and "check" in traffic


@pytest.mark.parametrize("metric", [m["name"] for m in _metrics()])
def test_every_metric_has_a_reader(metric):
    path = harness.BENCH_DIR / "metrics" / f"{metric}.py"
    assert path.exists(), path
    module = harness.load_module(path, "test_metric_" + metric.replace(".", "_"))
    assert callable(module.read) and module.__doc__


def test_run_refuses_without_a_card():
    """No CUDA device: exit other than 0 and no result line."""
    out = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         MANIFEST["workloads"][0]["name"], "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    try:
        import torch
        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if has_card:
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0
    assert out.stdout.strip() == "" and "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    """On the card: one short run of the first cell prints one result line."""
    out = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         MANIFEST["workloads"][0]["name"], "--seed", "2147483701", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
