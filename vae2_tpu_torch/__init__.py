"""VAE² video prediction in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``vae2_tpu`` (JAX/Flax/Pallas). It mirrors that package's layout
(``config``, ``data``, ``ops``, ``models``, ``core``, ``utils``, ``tools``)
and imports nothing of it. Tensors inside the models are NCHW in
``torch.channels_last`` memory, which is the JAX package's NHWC layout in
memory; a JAX NHWC array maps to the port by ``.permute(0, 3, 1, 2)``.
"""
