"""Inception Score (counterpart of ``vae2_tpu/eval/is_score.py``; reference
tools/inception_score.py). CLI in ``vae2_tpu_torch/tools/inception_score.py``.

Collects the images matching a filename pattern (a recursive glob, where
the reference copies them into an ImageFolder, :23-29), runs the
torchvision InceptionV3 classifier on the device, and computes
exp(E[KL(p(y|x) || p(y))]) over N splits (:32-97).

Weights: pass ``weights`` (an ``inception_v3_google-*.pth``) for comparable
numbers; random init otherwise.
"""

import glob
import os

import numpy as np
import torch
from PIL import Image
from scipy.stats import entropy

from ..models.inception import get_inception


def collect_files(path, pattern):
    """Recursively gather matching images (replaces the reference's
    move_files staging step, :23-29)."""
    files = sorted(glob.glob(os.path.join(path, "**", pattern), recursive=True))
    return [f for f in files
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))]


def split_scores(preds, splits):
    """(mean, std) over ``splits`` equal parts of the class probabilities
    ``preds`` (N, 1000) of exp(mean KL(p(y|x) || p(y))) (reference
    :84-95)."""
    n = len(preds)
    scores = []
    for k in range(splits):
        part = preds[k * (n // splits): (k + 1) * (n // splits)]
        py = np.mean(part, axis=0)
        scores.append(np.exp(np.mean([entropy(pyx, py) for pyx in part])))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(files, weights="", batch_size=32, splits=10,
                    resize=(256, 128), device="cuda"):
    """exp(mean over splits of E[KL(p(y|x) || p(y))]) (reference :32-97),
    the classifier on ``device``."""
    n = len(files)
    if not (batch_size > 0 and n > batch_size):
        raise ValueError(f"need more than batch_size={batch_size} images, "
                         f"got {n}")

    if not (weights and os.path.isfile(weights)):
        print("WARNING: no inception weights; IS uses a randomly initialized "
              "classifier and is NOT comparable to published numbers.")
    model = get_inception(weights, fid_variant=False, with_fc=True,
                          device=device)

    preds = np.zeros((n, 1000), np.float32)
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            chunk = files[start: start + batch_size]
            imgs = np.stack([
                np.asarray(Image.open(f).convert("RGB").resize(resize),
                           np.float32)[..., :3] / 255.0
                for f in chunk])
            logits = model(torch.from_numpy(imgs).to(device), with_logits=True)
            preds[start: start + len(chunk)] = torch.softmax(
                logits, dim=-1).cpu().numpy()
    return split_scores(preds, splits)
