"""Default configuration tree (a copy of ``vae2_tpu/config/defaults.py``).

Key names mirror the reference yacs tree (reference lib/config/default.py:17-127)
so reference experiment YAMLs and ``KEY VALUE`` CLI overrides port unchanged.
The ``TPU`` node is kept whole so that every recipe in ``experiments/`` loads
unchanged; of its knobs the PyTorch port reads ``TPU.DTYPE`` and
``TPU.INFER_SAMPLE_BATCH``. The ``GPU`` node holds the port's own knobs.
"""

from __future__ import annotations

from .node import ConfigNode


def _default_hrnet_extra() -> dict:
    """HRNet-W18-small-v2 stage spec — the flagship video-model trunk.

    The reference ships only segmentation YAMLs; the video configs referenced
    by tools/train.py:42 are absent, so this spec (w18-small-v2, as named in the
    default config filename) is authored here. The same vocabulary as the
    reference MODEL.EXTRA stage nodes (lib/config/models.py:20-50) is used.
    """
    return {
        "FINAL_CONV_KERNEL": 1,
        "IS_BASELINE": False,
        "BASELINE_MODE": "VAE_NATIVE",
        # VAE^2 latent knobs (absent from committed reference configs; required
        # by enc_hrnet.py:267-268).
        "HD_Z": True,
        "Z_DIM": 32,
        "STAGE1": {
            "NUM_MODULES": 1,
            "NUM_BRANCHES": 1,
            "NUM_BLOCKS": [2],
            "NUM_CHANNELS": [64],
            "BLOCK": "BOTTLENECK",
            "FUSE_METHOD": "SUM",
        },
        "STAGE2": {
            "NUM_MODULES": 1,
            "NUM_BRANCHES": 2,
            "NUM_BLOCKS": [2, 2],
            "NUM_CHANNELS": [18, 36],
            "BLOCK": "BASIC",
            "FUSE_METHOD": "SUM",
        },
        "STAGE3": {
            "NUM_MODULES": 3,
            "NUM_BRANCHES": 3,
            "NUM_BLOCKS": [2, 2, 2],
            "NUM_CHANNELS": [18, 36, 72],
            "BLOCK": "BASIC",
            "FUSE_METHOD": "SUM",
        },
        "STAGE4": {
            "NUM_MODULES": 2,
            "NUM_BRANCHES": 4,
            "NUM_BLOCKS": [2, 2, 2, 2],
            "NUM_CHANNELS": [18, 36, 72, 144],
            "BLOCK": "BASIC",
            "FUSE_METHOD": "SUM",
        },
    }


def get_default_config() -> ConfigNode:
    cfg = ConfigNode()

    cfg.OUTPUT_DIR = ""
    cfg.LOG_DIR = ""
    cfg.GPUS = [0]  # kept for recipe compat; ignored on TPU (mesh from TPU node)
    cfg.WORKERS = 4
    cfg.PRINT_FREQ = 20
    cfg.AUTO_RESUME = False
    cfg.PIN_MEMORY = True
    cfg.RANK = 0

    # Reference CUDNN block kept so reference YAMLs merge cleanly; ignored.
    cfg.CUDNN = ConfigNode({"BENCHMARK": True, "DETERMINISTIC": False, "ENABLED": True})

    cfg.MODEL = ConfigNode()
    cfg.MODEL.NAME = "enc_hrnet"
    cfg.MODEL.PRETRAINED = ""
    cfg.MODEL.EXTRA = ConfigNode(_default_hrnet_extra(), new_allowed=True)

    cfg.LOSS = ConfigNode(
        {"USE_OHEM": False, "OHEMTHRES": 0.9, "OHEMKEEP": 100000, "CLASS_BALANCE": True}
    )

    cfg.DATASET = ConfigNode()
    cfg.DATASET.ROOT = ""
    cfg.DATASET.DATASET = "cityscapessequence"
    # Video: channels emitted per prediction head (one RGB frame per head;
    # clip_length heads concat to the 3*clip_length-channel clip). The legacy
    # segmentation recipes override this to their class count (19 etc.).
    cfg.DATASET.NUM_CLASSES = 3
    cfg.DATASET.TRAIN_SET = ""
    cfg.DATASET.EXTRA_TRAIN_SET = ""
    cfg.DATASET.TEST_SET = ""
    cfg.DATASET.FIXED_LENGTH = False

    cfg.TRAIN = ConfigNode()
    cfg.TRAIN.IMAGE_SIZE = [256, 128]  # width x height
    cfg.TRAIN.BASE_SIZE = 256
    cfg.TRAIN.DOWNSAMPLERATE = 1
    cfg.TRAIN.FLIP = False
    cfg.TRAIN.MULTI_SCALE = False
    cfg.TRAIN.SCALE_FACTOR = 16
    cfg.TRAIN.CLIP_LENGTH = 3
    cfg.TRAIN.X1RECON_LAMBDA = 1.0
    cfg.TRAIN.X2RECON_LAMBDA = 0.1
    cfg.TRAIN.X3RECON_LAMBDA = 1.0
    cfg.TRAIN.GAN_LAMBDA = 1.0
    cfg.TRAIN.USE_X2RECON_MULTIPLIER = False
    cfg.TRAIN.LR_FACTOR = 0.1
    cfg.TRAIN.LR_STEP = [90, 110]
    cfg.TRAIN.LR = 0.01
    # '' = constant (reference adversarial training keeps poly decay
    # commented out, function.py:525-528); 'poly' = per-iter
    # lr*(1-i/max_iters)^LR_POWER (reference utils.py:459-463)
    cfg.TRAIN.LR_SCHEDULE = ""
    cfg.TRAIN.LR_POWER = 0.9
    cfg.TRAIN.EXTRA_LR = 0.001
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.MOMENTUM = 0.9
    cfg.TRAIN.WD = 0.0005
    cfg.TRAIN.NESTEROV = False
    cfg.TRAIN.IGNORE_LABEL = -1
    cfg.TRAIN.BEGIN_EPOCH = 0
    cfg.TRAIN.END_EPOCH = 484
    cfg.TRAIN.EXTRA_EPOCH = 0
    cfg.TRAIN.RESUME = False
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 8
    cfg.TRAIN.SHUFFLE = True
    cfg.TRAIN.NUM_SAMPLES = 0
    # keep a numbered copy of checkpoint.msgpack every N epochs (0: off) —
    # lets one training run feed a multi-checkpoint trajectory eval
    cfg.TRAIN.SNAPSHOT_EVERY = 0

    cfg.TEST = ConfigNode()
    cfg.TEST.IMAGE_SIZE = [256, 128]
    cfg.TEST.BASE_SIZE = 256
    cfg.TEST.BATCH_SIZE_PER_GPU = 8
    cfg.TEST.NUM_SAMPLES = 0
    cfg.TEST.MODEL_FILE = ""
    cfg.TEST.FLIP_TEST = False
    cfg.TEST.MULTI_SCALE = False
    cfg.TEST.CENTER_CROP_TEST = False
    cfg.TEST.SCALE_LIST = [1]

    cfg.DEBUG = ConfigNode(
        {
            "DEBUG": False,
            "SAVE_BATCH_IMAGES_GT": False,
            "SAVE_BATCH_IMAGES_PRED": False,
            "SAVE_HEATMAPS_GT": False,
            "SAVE_HEATMAPS_PRED": False,
        }
    )

    # ---- TPU-native additions (no reference counterpart) -------------------
    cfg.TPU = ConfigNode()
    cfg.TPU.MESH = ConfigNode()
    cfg.TPU.MESH.DATA = -1  # -1: all devices on the data axis
    cfg.TPU.MESH.SPATIAL = 1  # spatial (H) sharding factor for large images
    cfg.TPU.DTYPE = "bfloat16"  # compute dtype; params & BN stats stay float32
    cfg.TPU.DONATE = True  # donate state buffers into the jitted train step
    # jax.checkpoint granularity: 'trunk' (whole-trunk recompute; fits
    # 128x256 bs8 in HBM), 'stage' (per-HRModule), 'none'. Legacy booleans
    # map True->'trunk', False->'none'.
    cfg.TPU.REMAT = "trunk"
    cfg.TPU.SPLIT_STEP = False  # compile G/D updates separately (lower peak HBM)
    cfg.TPU.PREFETCH = 2  # host->device pipeline depth
    # Adam moment-buffer storage dtype: float32 (optax.adam) | bfloat16
    # (halves optimizer-state HBM; update math stays f32)
    cfg.TPU.ADAM_MOMENT_DTYPE = "float32"
    # 'xla' | 'pallas' fused BN+activation backend. Accepted and ignored by
    # the PyTorch port: there an eval BN whose activation is None,
    # leaky_relu or elu always goes through the fused-ABN kernel on a CUDA
    # tensor (ops/abn.py), and through its plain version on a CPU tensor.
    cfg.TPU.FUSED_ABN = "xla"
    # True: prediction heads consume the raw multi-resolution branch list
    # (1x1 conv commuted before the bilinear upsample — exact math, ~8x fewer
    # head FLOPs). Measured on v5e at inference chunk 256 this LOSES: the
    # per-head 270-channel full-res accumulation chains round-trip 4.25 GB
    # buffers through HBM (OOM at chunk>=192; 1248 f/s at 128 vs 2120 f/s
    # for the reference dataflow at 256). Default False = reference dataflow
    # (upsample-concat, one conv per head). The transform stays available
    # for memory-light regimes (e.g. small-batch training — A/B via
    # bench_train.py --multiscale-head).
    cfg.TPU.MULTISCALE_HEAD = False
    # Head dataflow: 'concat' (reference, conv1-of-concat), 'presum'
    # (per-branch conv1 + sum on pre-upsampled branches — exact rewrite that
    # skips the lane-misaligned 270-ch concat), 'multiscale' (conv before
    # upsample; loses at scale, kept as a knob). MULTISCALE_HEAD=True wins.
    cfg.TPU.HEAD_DATAFLOW = "concat"
    cfg.TPU.INFER_SAMPLE_BATCH = 32  # prior samples folded per device batch
    cfg.TPU.PROFILE_DIR = ""  # non-empty: jax.profiler trace of a step window
    cfg.TPU.PROFILE_STEPS = 5
    cfg.TPU.LAYER_SUMMARY = False  # per-layer FLOPs/params table at startup

    # ---- PyTorch port ------------------------------------------------------
    cfg.GPU = ConfigNode()
    cfg.GPU.DEVICE = "cuda"  # 'cuda' | 'cpu' (the CPU runs the plain ops)
    cfg.GPU.DTYPE = ""  # compute dtype; '' follows TPU.DTYPE

    return cfg
