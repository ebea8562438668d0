"""Command-line entry points (python -m vae2_tpu_torch.tools.<name>)."""
