"""The benchmark of relpose_gnn_tpu_torch, the PyTorch and CUDA port.

`python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once on the CUDA card (see run.py).
Nothing here imports JAX or the JAX package.
"""
