"""The benchmark of vae2_tpu_torch on the H100: ``python3 -m benchmark.run``."""
