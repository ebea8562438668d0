"""Histogram-based segmentation metrics (a copy of
``vae2_tpu/utils/metric.py:11-59``; reference lib/utils/metric.py:17-81 and
lib/utils/utils.py:434-457). Numpy; the one difference is the layout of the
logits that ``get_confusion_matrix`` takes: NCHW, the port's, where the JAX
package takes NHWC."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def fast_hist(label_true: np.ndarray, label_pred: np.ndarray,
              num_classes: int) -> np.ndarray:
    mask = (label_true >= 0) & (label_true < num_classes)
    return np.bincount(
        num_classes * label_true[mask].astype(int) + label_pred[mask],
        minlength=num_classes**2,
    ).reshape(num_classes, num_classes)


def get_confusion_matrix(label: np.ndarray, pred_logits: np.ndarray,
                         num_classes: int, ignore: int = -1) -> np.ndarray:
    """Confusion matrix from (N, C, H, W) logits and (N, H, W) int labels
    (reference utils.py:434-457)."""
    seg_pred = np.argmax(pred_logits, axis=1)
    valid = label != ignore
    return fast_hist(label[valid], seg_pred[valid], num_classes)


def scores(label_trues: List[np.ndarray], label_preds: List[np.ndarray],
           num_classes: int) -> Dict:
    """Overall/mean accuracy, mean IoU, fwavacc, per-class IoU
    (reference metric.py:17-37)."""
    hist = np.zeros((num_classes, num_classes))
    for lt, lp in zip(label_trues, label_preds):
        hist += fast_hist(lt.flatten(), lp.flatten(), num_classes)
    acc = np.diag(hist).sum() / hist.sum()
    acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
    iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
    mean_iu = np.nanmean(iu)
    freq = hist.sum(axis=1) / hist.sum()
    fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return {
        "Overall Acc": acc,
        "Mean Acc": acc_cls,
        "FreqW Acc": fwavacc,
        "Mean IoU": mean_iu,
        "Class IoU": dict(zip(range(num_classes), iu)),
    }


def miou_from_confusion(confusion: np.ndarray) -> tuple:
    """(mean_IoU, per_class_IoU) from an accumulated confusion matrix
    (reference core/function.py:739-744)."""
    pos = confusion.sum(1)
    res = confusion.sum(0)
    tp = np.diag(confusion)
    iou = tp / np.maximum(1.0, pos + res - tp)
    return iou.mean(), iou
