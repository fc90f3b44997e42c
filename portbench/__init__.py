"""The benchmark of the PyTorch and CUDA port (`pbmm_tpu_torch`) on an
NVIDIA H100: `python3 portbench/run.py --workload <config>.<traffic>
--seed <n> --seconds <s> --trace <0|1>` from the repository's root."""
