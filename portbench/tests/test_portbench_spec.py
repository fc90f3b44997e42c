"""BENCHMARK.json against the contract's shapes, and the harness's
lookup by name: every cell resolves to its files, and files dropped into
a copy of the benchmark are found without an edit."""

import json
import shutil

import pytest

from portbench.harness import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [m["name"] for m in metrics]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for name in names:
        assert spec.NAME_RE.match(name), name
    for unit in (m["unit"] for m in metrics):
        assert spec.UNIT_RE.match(unit), unit
    texts = ([w["why"] for w in BENCH["workloads"]]
             + [c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    wl = spec.workload(BENCH, cell)
    cfg = spec.config(wl["config"])
    assert cfg["name"] == wl["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"]
    tr = spec.traffic(wl["traffic"])
    kind = spec.kind(tr["kind"])
    for fn in ("setup", "window", "end_to_end", "kept", "release"):
        assert callable(getattr(kind, fn))
    assert spec.limits(cell)["compared"]
    readers = [spec.metric_reader(m["name"])
               for m in spec.cell_metrics(BENCH, cell, True)]
    assert readers and all(callable(r.read) for r in readers)
    e2e = [m["name"] for m in spec.cell_metrics(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2


def test_every_config_is_used_and_every_metric_reports_somewhere():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        cells = [c for c in CELLS if spec.applies(m, c)]
        assert cells
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert all(spec.applies(moved, c) for c in cells)


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    bench_dir = root / "portbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (bench_dir / "configs" / "new_cfg.json").write_text(json.dumps(
        dict(spec.config("ref1080"), name="new_cfg", height=720)))
    (bench_dir / "traffic" / "new_mix.json").write_text(json.dumps(
        dict(spec.traffic("u8_clip16"), chunk_frames=8)))
    (bench_dir / "limits" / "new_cfg.new_mix.json").write_text(
        json.dumps({"compared": {"mismatch_pct": {"max": 1.0}}}))
    (bench_dir / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = spec.benchmark(root)
    wl = spec.workload(loaded, "new_cfg.new_mix")
    assert spec.config(wl["config"], bench_dir)["height"] == 720
    assert spec.traffic(wl["traffic"], bench_dir)["chunk_frames"] == 8
    assert spec.limits("new_cfg.new_mix", bench_dir)["compared"]
    assert spec.metric_reader("new_metric", bench_dir).read(None) == 1.0
    assert spec.kind("clip", bench_dir).setup
