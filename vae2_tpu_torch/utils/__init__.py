"""Runtime utilities: devices, kernel builds, logging, checkpoints, JAX weight import."""
