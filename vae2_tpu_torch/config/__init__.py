"""Config system: yacs-compatible key tree, YAML merge, CLI overrides.

Unlike ``vae2_tpu.config`` there is no process-wide ``config`` object: each
caller builds its own tree, so that entry points can run more than once in
one process.

    from vae2_tpu_torch.config import get_default_config, update_config
    cfg = update_config(get_default_config(), args)  # args has .cfg, .opts
"""

from .defaults import get_default_config
from .node import ConfigNode


def update_config(cfg: ConfigNode, args) -> ConfigNode:
    """Merge a YAML file and a KEY VALUE override list, then freeze
    (reference lib/config/default.py:121-127)."""
    cfg.defrost()
    if getattr(args, "cfg", None):
        cfg.merge_from_file(args.cfg)
    cfg.merge_from_list(getattr(args, "opts", None))
    cfg.freeze()
    return cfg


__all__ = ["ConfigNode", "get_default_config", "update_config"]
