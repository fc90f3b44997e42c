"""The port's multi-process harness (`pbmm_tpu_torch.tools.multihost
--spawn 2 --device cpu`): 2 gloo processes of one rank each run the
data- and frame-parallel scenarios of `magnify_batch_sharded` and hold
them to the 1-process run, as `tests/test_multihost.py` does for the
JAX package; the JSON goes only to `--json-out`."""

import json
import os
import socket
import subprocess
import sys

import pytest


def _sockets_available() -> bool:
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
        return True
    except OSError:
        return False


@pytest.mark.skipif(not _sockets_available(),
                    reason="no loopback sockets for the rendezvous")
def test_two_process_harness(tmp_path):
    out = tmp_path / "mh.json"
    res = subprocess.run(
        [sys.executable, "-m", "pbmm_tpu_torch.tools.multihost",
         "--spawn", "2", "--device", "cpu", "--videos", "4", "--frames",
         "8", "--size", "32", "--reps", "2", "--json-out", str(out)],
        capture_output=True, timeout=300,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert res.returncode == 0, res.stderr.decode()[-3000:]
    doc = json.loads(out.read_text())
    assert doc["processes"] == 2 and doc["device"] == "cpu"
    for name in ("data_parallel", "frame_parallel"):
        sc = doc["scenarios"][name]
        assert sc["multi_process"]["global_devices"] == 2
        assert sc["single_process"]["global_devices"] == 1
        p = sc["parity_psnr_db_vs_single"]
        assert p == "bit-identical" or float(p) > 70.0
    # The frame-parallel scenario's frames span both processes.
    assert doc["scenarios"]["frame_parallel"]["multi_process"]["mesh"] == {
        "data": 1, "frame": 2}
    assert doc["scenarios"]["data_parallel"]["multi_process"]["mesh"] == {
        "data": 2, "frame": 1}


def test_harness_needs_a_mode():
    from pbmm_tpu_torch.tools import multihost

    with pytest.raises(SystemExit):
        multihost.main([])
