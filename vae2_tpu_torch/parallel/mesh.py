"""The data-parallel layout of a run (counterpart of ``make_mesh``'s checks
and ``shard_state``, vae2_tpu/parallel/mesh.py:29-44, 82-85).

The JAX package trains one program over a (data, spatial) device mesh. The
port runs one process per rank on the ``data`` axis only: parameters and
optimizer state are replicated, the batch is split by the loader
(``data/loader.py``), and the reductions over the axis are the collectives
of ``parallel/sync.py``.
"""

from __future__ import annotations

from torch import nn

from . import sync


def check_mesh(config, world_size: int) -> None:
    """Refuse the TPU.MESH settings the port cannot run: spatial (H)
    sharding, and a data axis other than the number of ranks."""
    spatial = int(config.TPU.MESH.SPATIAL)
    data = int(config.TPU.MESH.DATA)
    if spatial > 1:
        raise ValueError(f"TPU.MESH.SPATIAL {spatial}: vae2_tpu_torch has no "
                         "spatial (H) sharding; set it to 1")
    if data > 0 and data != world_size:
        raise ValueError(f"TPU.MESH.DATA {data} differs from the {world_size} "
                         "rank(s) of this run (WORLD_SIZE); set it to -1 or "
                         f"{world_size}")


def broadcast_state(module: nn.Module, src: int = 0) -> None:
    """Every rank's parameters and buffers set to rank ``src``'s (the role
    of ``shard_state``): once after build, pretrained import and resume."""
    sync.broadcast_(list(module.parameters()) + list(module.buffers()), src)
