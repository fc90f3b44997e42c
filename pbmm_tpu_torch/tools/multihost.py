"""Multi-process runs of the sharded engines over `torch.distributed`.

Counterpart of `pbmm_tpu/tools/multihost.py`.  N separate processes, one
rank each, joined by `torch.distributed` over a loopback TCP rendezvous:
the initialisation, mesh, per-rank input slicing and cross-process
collectives a multi-card job uses.  Each rank takes the CUDA card of its
local rank (NCCL; one card a rank), or runs on the CPU over gloo with
`--device cpu`.

    python -m pbmm_tpu_torch.tools.multihost --spawn 4 --device cpu \\
        [--videos 4 --frames 8 --size 48 --reps 3 --json-out run.json]

Harness mode (`--spawn N`): runs two scenarios of `magnify_batch_sharded`
(`MagnifyConfig()`), data-parallel (videos over the whole "data" axis)
and frame-parallel (one video, its frames over every rank, so the 1-frame
spectrum halo crosses the process boundary), each in a world of 1 and of
N processes; checks the N-process result against the 1-process one (> 70
dB or bit-identical) and prints one JSON document (also written to
`--json-out` when given).  It exits non-zero when parity fails.

Worker mode (`--worker`): one rank of a spawned world.  It reads its
inputs and cases from an `.npz` (`--cases`; `write_cases` makes one),
runs each case through the port's engines (timing the engine's call
alone), gathers every rank's block into the whole output and rank 0
writes the outputs to `--out`, with its own block's shape in the report
(`run_cases` spawns the workers and reads them back).  Cases
name an engine (`video_spatial`, `pair_spatial`, `batch_sharded`), a
mesh, a config and their inputs; a case that raises records its error in
place of an output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_ENGINES = ("video_spatial", "pair_spatial", "batch_sharded")


def make_config(spec: dict):
    """A `MagnifyConfig` from a case's config spec: constructor fields
    ("temporal" a dict of `TemporalConfig` fields), then `tuned_for_tpu()`
    when "tuned", then the "replace" fields."""
    from pbmm_tpu_torch.config import MagnifyConfig, TemporalConfig

    def fields(d):
        d = dict(d)
        if "temporal" in d:
            d["temporal"] = TemporalConfig(**d["temporal"])
        return d

    cfg = MagnifyConfig(**fields(spec.get("fields", {})))
    if spec.get("tuned"):
        cfg = cfg.tuned_for_tpu()
    return cfg.replace(**fields(spec.get("replace", {})))


def write_cases(path: str, cases: list, arrays: dict) -> None:
    """An `.npz` of input arrays and a case list for worker mode.  Each
    case: {"name", "engine" (one of `_ENGINES`), "mesh" (shape),
    "axes" (names), "config" (`make_config`'s spec), "inputs" (array
    names), "reps" (steady-state repetitions to time, default 0)}."""
    for c in cases:
        if c["engine"] not in _ENGINES:
            raise ValueError(f"unknown engine {c['engine']!r}")
    np.savez(path, __cases__=np.array(json.dumps(cases)), **arrays)


def _run_case(case: dict, data, device):
    import torch

    from pbmm_tpu_torch.parallel.mesh import make_mesh
    from pbmm_tpu_torch.parallel.sharding import (
        gather_blocks,
        local_block,
        magnify_batch_sharded,
    )
    from pbmm_tpu_torch.parallel.spatial import (
        gather_spatial,
        magnify_frame_pair_spatial,
        magnify_video_spatial,
    )

    cfg = make_config(case["config"])
    ins = [torch.from_numpy(np.ascontiguousarray(data[k])).to(device)
           for k in case["inputs"]]
    eng = case["engine"]
    mesh = make_mesh(tuple(case["mesh"]), tuple(case["axes"]))
    if eng == "video_spatial":
        def call():
            return magnify_video_spatial(ins[0], cfg, mesh)

        def gather(out):
            return gather_spatial(out, mesh)
    elif eng == "pair_spatial":
        def call():
            return magnify_frame_pair_spatial(ins[0], ins[1], cfg, mesh)

        def gather(out):
            return gather_spatial(out[None], mesh)[0]
    else:
        block = local_block(ins[0], mesh).contiguous()

        def call():
            return magnify_batch_sharded(block, cfg, mesh)

        def gather(out):
            return gather_blocks(out, mesh)
    t0 = time.perf_counter()
    out = call()
    first = time.perf_counter() - t0
    reps = int(case.get("reps", 0))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = call()
    if device.type == "cuda":
        torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / reps if reps else None
    info = {"seconds_first": first, "seconds_steady": steady,
            "mesh": dict(zip(mesh.mesh_dim_names,
                             (int(s) for s in mesh.mesh.shape))),
            "block_shape": list(out.shape)}
    return gather(out).cpu().numpy(), info


def run_worker(args) -> int:
    """One rank: initialise the world, run every case, rank 0 writes."""
    import torch
    import torch.distributed as dist

    from pbmm_tpu_torch.parallel.launcher import init_world, rank_device

    torch.set_num_threads(1)
    device = rank_device(args.device, args.rank)
    # A world of one too: it still runs its collectives.
    init_world(args.init_method, args.world_size, args.rank, device)
    try:
        data = np.load(args.cases)
        outs, report = {}, {"world": dist.get_world_size(),
                            "device": str(device), "cases": {}}
        for case in json.loads(str(data["__cases__"])):
            try:
                out, info = _run_case(case, data, device)
                outs[case["name"]] = out
            except (ValueError, NotImplementedError) as e:
                info = {"error": f"{type(e).__name__}: {e}"}
            report["cases"][case["name"]] = info
        if args.rank == 0:
            np.savez(args.out, __report__=np.array(json.dumps(report)),
                     **outs)
    finally:
        dist.destroy_process_group()
    return 0


def run_cases(cases: list, arrays: dict, world: int, device: str = "cuda",
              timeout: float = 600.0):
    """Spawn `world` worker processes on `cases` over `arrays`; returns
    ({case name: output array}, report).  Raises when a worker fails or
    times out (all workers are then killed)."""
    with tempfile.TemporaryDirectory(prefix="pbmm_mh_") as workdir:
        return _run_cases(cases, arrays, world, device, timeout, workdir)


def _run_cases(cases, arrays, world, device, timeout, workdir):
    cases_path = os.path.join(workdir, "cases.npz")
    out_path = os.path.join(workdir, "out.npz")
    from pbmm_tpu_torch.parallel.launcher import free_port

    write_cases(cases_path, cases, arrays)
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    # The workers import the package this module belongs to.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [x for x in [env.get("PYTHONPATH")] if x])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pbmm_tpu_torch.tools.multihost",
         "--worker", "--rank", str(r), "--world-size", str(world),
         "--init-method", init, "--device", device, "--cases", cases_path,
         "--out", out_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        failed = []
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"worker {r} of {world} timed out")
            if p.returncode != 0:
                failed.append(f"worker {r} of {world} rc={p.returncode}\n"
                              f"{err.decode()[-2000:]}")
        if failed:  # every failed rank's tail: the first to fail may be any
            raise RuntimeError("\n".join(failed))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with np.load(out_path) as res:
        report = json.loads(str(res["__report__"]))
        return {k: res[k] for k in res.files if k != "__report__"}, report


def _make_batch(n_videos: int, frames: int, size: int) -> np.ndarray:
    from pbmm_tpu_torch.oracle.synthetic import oscillating_gaussian_blob

    base = oscillating_gaussian_blob(height=size, width=size, frames=frames)
    return np.stack(
        [np.roll(base, shift=v, axis=2) for v in range(n_videos)]
    ).astype(np.float32)


def run_harness(args) -> int:
    """The data- and frame-parallel scenarios in worlds of 1 and N
    processes; parity of N against 1; one JSON document."""
    from pbmm_tpu_torch.parallel.mesh import mesh_shape_for
    from pbmm_tpu_torch.utils.metrics import psnr

    doc = {
        "kind": "multi-process run: torch.distributed over a loopback TCP "
                "rendezvous, N processes of one rank each "
                f"({args.device}) - initialisation, mesh, per-rank input "
                "slicing and cross-process collectives (the frame halo "
                "crosses the process boundary)",
        "processes": args.spawn,
        "device": args.device,
        "scenarios": {},
    }
    ok = True
    scenarios = {"data_parallel": args.videos, "frame_parallel": 1}
    arrays = {name: _make_batch(videos, args.frames, args.size)
              for name, videos in scenarios.items()}
    results, outs = {}, {}
    for n in (1, args.spawn):
        cases = [{"name": name, "engine": "batch_sharded",
                  "mesh": list(mesh_shape_for(n, videos)),
                  "axes": ["data", "frame"], "config": {},
                  "inputs": [name], "reps": args.reps}
                 for name, videos in scenarios.items()]
        got, report = run_cases(cases, arrays, n, args.device, args.timeout)
        for name in scenarios:
            info = report["cases"][name]
            if "error" in info:
                raise RuntimeError(f"{name} x{n}: {info['error']}")
            outs[name, n] = got[name]
            results[name, n] = {"processes": n,
                                "global_devices": report["world"], **info}
            print(f"[multihost] {name} x{n}: steady "
                  f"{info['seconds_steady'] * 1e3:.1f} ms/batch, mesh "
                  f"{info['mesh']}", file=sys.stderr)
    for name, videos in scenarios.items():
        p = float(psnr(outs[name, args.spawn], outs[name, 1]))
        t1 = results[name, 1]["seconds_steady"]
        tn = results[name, args.spawn]["seconds_steady"]
        doc["scenarios"][name] = {
            "workload": {"videos": videos, "frames": args.frames,
                         "size": args.size},
            "single_process": results[name, 1],
            "multi_process": results[name, args.spawn],
            "parity_psnr_db_vs_single": (p if np.isfinite(p)
                                         else "bit-identical"),
            "speedup_vs_single_process": t1 / tn,
        }
        ok &= not np.isfinite(p) or p > 70.0
    doc["note"] = (
        "host-clock seconds of N processes sharing one machine's cores, "
        "with collectives on loopback TCP (gloo) or on the cards of one "
        "host (NCCL): the run shows initialisation, slicing, cross-process "
        "collectives and parity, not scaling")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    if not ok:
        print("multi-process parity broken", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="harness mode: spawn N one-rank workers and verify")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (a card a rank, NCCL) or 'cpu' (gloo)")
    ap.add_argument("--videos", type=int, default=4)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--json-out", default="")
    ap.add_argument("--worker", action="store_true",
                    help="worker mode: one rank of a spawned world")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--init-method", default="")
    ap.add_argument("--cases", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.worker:
        return run_worker(args)
    if args.spawn:
        return run_harness(args)
    ap.error("pass --spawn N (harness) or --worker (one rank)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
