"""`run.py` without a card: it exits with a code other than 0 and
prints no result (it never falls back to the CPU)."""

import subprocess
import sys

import pytest

from portbench.harness import spec


def test_exits_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ref1080.u8_clip16", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=spec.ROOT)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr
