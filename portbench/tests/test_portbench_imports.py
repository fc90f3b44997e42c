"""What the benchmark loads: nothing of JAX or of the JAX package
anywhere (top-level module names compared whole: `pbmm_tpu_torch` is
not `pbmm_tpu`), and nothing of the program in the reference."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "pbmm_tpu"}
SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py")
                 if "tests" not in p.parts)


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(spec.BENCH_DIR)))
def test_no_jax_import(path):
    assert not FORBIDDEN & set(_top_imports(path))
    if "reference" in path.parts:
        assert "pbmm_tpu_torch" not in set(_top_imports(path))


def _loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, cwd=spec.ROOT, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _loaded_after(
        "import sys; sys.path.insert(0, 'portbench/tests'); "
        "sys.path.insert(0, '.'); import torch; torch.set_num_threads(1); "
        "from tiny import run_tiny; run_tiny('ref1080.u8_clip16', "
        "seconds=0.1); import portbench.run")
    assert "pbmm_tpu_torch" in loaded
    assert not FORBIDDEN & loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import portbench.reference.torch_ref, portbench.harness.check")
    assert not ({"pbmm_tpu_torch"} | FORBIDDEN) & loaded
