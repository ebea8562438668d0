"""The (data, spatial) rank layout of a run (counterpart of ``make_mesh``'s
checks and ``shard_state``, vae2_tpu/parallel/mesh.py:29-53, 82-85).

The JAX package trains one program over a (data, spatial) device mesh: the
batch is split over ``data``, the image's H over ``spatial``, and XLA
inserts the convolutions' halo exchanges. The port runs one process per
rank: rank r is data index ``r // S`` and spatial index ``r % S`` (the
mesh's ``reshape(n // S, S)``, mesh.py:43). Parameters and optimizer state
are replicated; the loader gives each rank its data shard's clips and its
own block of H rows (``data/loader.py``); the reductions and the halo
exchanges are the collectives of ``parallel/sync.py``, and each rank owns
the rows of every branch that ``sync.row_range`` gives it.
"""

from __future__ import annotations

import torch.distributed as dist
from torch import nn

from . import sync


def layout(config, world_size: int):
    """(D, S) of TPU.MESH for ``world_size`` ranks: S = SPATIAL, D = DATA,
    or ``world_size // S`` when DATA is -1."""
    spatial = int(config.TPU.MESH.SPATIAL)
    data = int(config.TPU.MESH.DATA)
    return (data if data > 0 else world_size // max(spatial, 1)), spatial


def check_mesh(config, world_size: int) -> None:
    """Refuse the TPU.MESH settings the port cannot run, as the JAX mesh
    refuses them: a SPATIAL that does not divide the ranks, DATA x SPATIAL
    other than the ranks, and a spatial split of an image whose H rows do
    not divide by S (``jax.device_put`` of ``P('data', 'spatial')``: "should
    be divisible by S"). A deeper branch may split unevenly: its ranks then
    own unequal rows (``sync.row_range``)."""
    data, spatial = layout(config, world_size)
    if spatial < 1 or world_size % spatial:
        raise ValueError(f"TPU.MESH.SPATIAL {spatial} does not divide the "
                         f"{world_size} rank(s) of this run (WORLD_SIZE)")
    if data * spatial != world_size:
        raise ValueError(f"TPU.MESH.DATA {data} x TPU.MESH.SPATIAL {spatial} "
                         f"differs from the {world_size} rank(s) of this run "
                         f"(WORLD_SIZE); set DATA to -1 or "
                         f"{world_size // spatial}")
    height = int(config.TRAIN.IMAGE_SIZE[1])
    if spatial > 1 and height % spatial:
        raise ValueError(
            f"TPU.MESH.SPATIAL {spatial}: an image of {height} rows does not "
            f"split over {spatial} ranks (its height should be divisible by "
            f"{spatial})")


def init_layout(config, world_size: int) -> None:
    """Build the spatial and data process groups of TPU.MESH and set this
    rank's layout (``sync.set_layout``). Every rank calls ``new_group`` for
    every group, in the same order: first the D spatial groups (ranks
    ``d*S .. d*S + S - 1``), then the S data groups (ranks ``s, s + S,
    ...``). With S = 1 nothing is built: the world is the data axis."""
    check_mesh(config, world_size)
    data, spatial = layout(config, world_size)
    if spatial == 1:
        sync.set_layout()
        return
    if not dist.is_initialized():
        raise RuntimeError(f"TPU.MESH.SPATIAL {spatial} needs a process "
                           "group of SPATIAL x DATA ranks")
    rank = dist.get_rank()
    spatial_group = data_group = None
    for d in range(data):
        g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
        if rank // spatial == d:
            spatial_group = g
    for s in range(spatial):
        g = dist.new_group(list(range(s, world_size, spatial)))
        if rank % spatial == s:
            data_group = g
    sync.set_layout(spatial, spatial_group, data_group)


def broadcast_state(module: nn.Module, src: int = 0) -> None:
    """Every rank's parameters and buffers set to rank ``src``'s (the role
    of ``shard_state``): once after build, pretrained import and resume."""
    sync.broadcast_(list(module.parameters()) + list(module.buffers()), src)
