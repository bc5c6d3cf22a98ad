"""The benchmark of the PyTorch and CUDA port (``csparse3_tpu_torch``):
batched power-system studies on grids of published sizes.  Run one cell
once with ``python3 gridbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the checkout's root."""
