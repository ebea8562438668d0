"""Frechet Inception Distance (counterpart of ``vae2_tpu/eval/fid.py``;
reference tools/fid_score.py, itself a pytorch-fid port). CLI in
``vae2_tpu_torch/tools/fid_score.py``.

Pool3 activations come from the FID InceptionV3 (``models/inception.py``)
on the device, in float32 with TF32 off, gathered into float64 on the host;
the Frechet distance is the stable scipy ``sqrtm`` formulation (reference
fid_score.py:468-522). Images are loaded at 256x128 as the reference does
(:398-402). The last batch is not padded: each image's features do not
depend on the others' in eval mode.

Weights: pass ``weights`` (a ``pt_inception-2015-12-05-*.pth``) for
comparable numbers; without it the network is randomly initialized, FID is
only self-consistent, and a warning is printed.
"""

import glob
import os
import pathlib

import numpy as np
import torch
from PIL import Image
from scipy import linalg

from ..models.inception import get_inception

IMAGE_EXTS = ("jpg", "jpeg", "png", "bmp")


def imread(filename):
    """(128, 256, 3) uint8, resized on load (reference fid_score.py:398-402)."""
    return np.asarray(
        Image.open(filename).resize((256, 128)), dtype=np.uint8)[..., :3]


def list_images(path, pattern=None):
    if pattern:
        return sorted(glob.glob(os.path.join(path, pattern)))
    p = pathlib.Path(path)
    files = []
    for ext in IMAGE_EXTS:
        files += list(p.glob(f"*.{ext}"))
    return sorted(str(f) for f in files)


def get_activations(files, model, batch_size=50):
    """Pool3 activations (N, 2048) float64 of all images, batched on the
    model's device (reference fid_score.py:405-466)."""
    device = next(model.parameters()).device
    out = np.empty((len(files), 2048), np.float64)
    with torch.inference_mode():
        for start in range(0, len(files), batch_size):
            chunk = files[start: start + batch_size]
            images = np.stack([imread(f).astype(np.float32) / 255.0
                               for f in chunk])
            feats = model(torch.from_numpy(images).to(device))
            out[start: start + len(chunk)] = feats.double().cpu().numpy()
    return out


def calculate_activation_statistics(files, model, batch_size=50):
    act = get_activations(files, model, batch_size)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """d^2 = ||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)), stable sqrtm
    handling (reference fid_score.py:468-522)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"mean shapes {mu1.shape}, {mu2.shape} or "
                         f"covariance shapes {sigma1.shape}, {sigma2.shape} "
                         "differ")

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        print(f"fid calculation produces singular product; adding {eps} to "
              "diagonal of cov estimates")
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(covmean))


def _path_statistics(path, pattern, model, batch_size):
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    files = list_images(path, pattern)
    if not files:
        raise RuntimeError(f"No images found under {path} ({pattern})")
    return calculate_activation_statistics(files, model, batch_size)


def _model(weights, device):
    if not (weights and os.path.isfile(weights)):
        print("WARNING: no inception weights file; using random init — FID is "
              "self-consistent but NOT comparable to published numbers. Pass "
              "--weights pt_inception-2015-12-05-6726825d.pth for parity.")
    return get_inception(weights, fid_variant=True, device=device)


def calculate_fid_given_paths(paths, batch_size=50, patterns=(None, None),
                              weights="", device="cuda"):
    """FID between two image directories / .npz statistics files
    (reference fid_score.py:565-588), Inception on ``device``."""
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    model = _model(weights, device)
    m1, s1 = _path_statistics(paths[0], patterns[0], model, batch_size)
    m2, s2 = _path_statistics(paths[1], patterns[1], model, batch_size)
    return calculate_frechet_distance(m1, s1, m2, s2)


def save_statistics(path, pattern, out_npz, batch_size=50, weights="",
                    device="cuda"):
    """Precompute (mu, sigma) for a directory into an .npz."""
    mu, sigma = _path_statistics(path, pattern, _model(weights, device),
                                 batch_size)
    np.savez(out_npz, mu=mu, sigma=sigma)
