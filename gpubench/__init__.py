"""The benchmark of the PyTorch/CUDA port (``gnss_sdr_tpu_torch``):
``gpubench/run.py`` runs one cell of ``BENCHMARK.json`` once."""
