"""The benchmark's CPU tests: `python -m pytest portbench/tests -q` from
the repository's root.  Torch keeps to one intra-op thread here."""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(1)
