"""The benchmark's specification, found by name.

A cell `<config>.<traffic>` of `BENCHMARK.json` resolves to files of its
own under `portbench/`:

- `configs/<config>.json`: the `MagnifyConfig` fields ("magnify"), the
  frame size, the source, `assumed` and `reduced`;
- `traffic/<traffic>.json`: the generator kind (`kinds/<kind>.py`), the
  frame format the client sends, the output layout and the mix's
  parameters;
- `limits/<cell>.json`: the numbers `correct` compares and their limits;
- `metrics/<metric>.py`: one reader for each per-layer metric.

Adding a configuration, a mix, a kind or a metric adds files and entries;
no file that exists changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

FORMATS = {"u8_planar": "planar_u8", "f32_interleaved": "interleaved"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "configs" / f"{name}.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    t = load_json(bench_dir / "traffic" / f"{name}.json")
    if FORMATS.get(t["format"]) != t["output_layout"]:
        raise ValueError(f"traffic {name!r}: format {t['format']!r} goes "
                         f"with output layout {FORMATS.get(t['format'])!r}")
    return t


def limits(cell: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "limits" / f"{cell}.json")


def _load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The traffic generator `kinds/<name>.py`."""
    return _load_file(bench_dir / "kinds" / f"{name}.py",
                      f"portbench_kind_{name}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader `metrics/<name>.py` of a per-layer metric: `read(run)`
    returns its value or None, and `ENTRY`, where it has one, names the
    program's function (`module:attribute`) whose calls it times."""
    return _load_file(bench_dir / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_"))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on), in `BENCHMARK.json`'s order."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if applies(m, cell)]
