"""The benchmark of the PyTorch and CUDA port (``fesom2_accelerate_tpu_torch``)
on NVIDIA H100 cards: ``python3 -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.
It imports neither jax nor the JAX package."""
