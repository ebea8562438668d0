"""Segmentation engine: train / validate / testval / test (counterpart of
``vae2_tpu/core/seg_loop.py:35-262``; reference lib/core/function.py:
607-780).

- ``make_seg_train_step``: a train-mode forward, CE or OHEM loss, backward,
  ``optimizer.step()``; the BN running statistics update once per step.
- ``seg_train`` logs the poly learning rate and, as the JAX package's loop,
  does not apply it (the optimizer's lr stays TRAIN.LR).
- ``make_infer_fn``: eval-mode logits upsampled x4 (bilinear) to the input.
- ``whole_image_logits`` zero-pads the image to a multiple of 32 and crops
  the logits back, as the JAX package does (it pads to limit XLA's
  compiles; the pad changes the logits near the bottom and right border,
  and the port computes what the JAX package computes).
- ``flip_tta``, ``multi_scale_inference`` (a fixed-size window sliding over
  each scale), ``seg_validate``, ``seg_testval``, ``seg_test``.

Networks take NCHW tensors; the host side keeps the JAX package's HWC
numpy images and logits (``whole_image_logits``, ``multi_scale_inference``,
``seg_testval``), resized with ``data/resize.py``'s copies of cv2's.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.resize import pad_constant, resize_linear
from ..ops.image import resize_bilinear
from ..utils.logging import AverageMeter
from ..utils.metric import get_confusion_matrix, miou_from_confusion
from ..utils.schedule import adjust_learning_rate
from .losses import cross_entropy_loss, ohem_cross_entropy

logger = logging.getLogger("vae2_tpu_torch")


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_seg_train_step(model, optimizer, ignore_label: int = -1,
                        use_ohem: bool = False, ohem_thres: float = 0.9,
                        ohem_kept: int = 100000,
                        class_weights: Optional[np.ndarray] = None) -> Callable:
    """``step(images, labels) -> loss``: images (B, 3, H, W) float, labels
    (B, H, W) int, moved to the model's device; the loss is detached."""
    device = _device(model)
    weights = (None if class_weights is None
               else torch.as_tensor(np.asarray(class_weights, np.float32),
                                    device=device))

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        images = images.to(device, non_blocking=True)
        labels = labels.to(device, non_blocking=True)
        model.train()
        logits = model(images)
        if use_ohem:
            loss = ohem_cross_entropy(logits, labels, ignore_label,
                                      ohem_thres, ohem_kept, weights)
        else:
            loss = cross_entropy_loss(logits, labels, ignore_label, weights)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def seg_train(config, epoch: int, num_epoch: int, epoch_iters: int,
              base_lr: float, num_iters: int, loader, step: Callable,
              writer_dict=None) -> None:
    """One training epoch (reference function.py:607-655); the loss is read
    back at print points only."""
    ave_loss = AverageMeter()
    tic = time.time()
    cur_iters = epoch * epoch_iters
    for i_iter, (images, labels, _, _) in enumerate(loader):
        loss = step(images, labels)
        lr = adjust_learning_rate(base_lr, num_iters, i_iter + cur_iters)
        if i_iter % config.PRINT_FREQ == 0:
            ave_loss.update(float(loss))
            logger.info(
                "Epoch: [%d/%d] Iter:[%d/%d], Time: %.2f, lr: %.6f, "
                "Loss: %.6f", epoch, num_epoch, i_iter, epoch_iters,
                time.time() - tic, lr, ave_loss.average())
            tic = time.time()
            if writer_dict is not None:
                writer = writer_dict["writer"]
                gs = writer_dict["train_global_steps"]
                writer.add_scalar("train_loss", ave_loss.average(), gs)
                writer.add_scalar("learning_rate", lr, gs)
                writer_dict["train_global_steps"] = gs + 1


def make_infer_fn(model) -> Callable:
    """``infer(images) -> logits``: eval-mode logits of (B, 3, H, W) images
    (moved to the model's device), upsampled bilinearly to (H, W), f32."""
    device = _device(model)

    def infer(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            images = images.to(device, non_blocking=True)
            logits = model(images)
            return resize_bilinear(logits, images.shape[2], images.shape[3])

    return infer


def _nchw(image: np.ndarray) -> torch.Tensor:
    """An (H, W, 3) numpy image as a (1, 3, H, W) channels_last tensor."""
    return torch.from_numpy(np.ascontiguousarray(image))[None].permute(
        0, 3, 1, 2)


def _hwc(logits: torch.Tensor) -> np.ndarray:
    """(1, C, H, W) logits as an (H, W, C) numpy array."""
    return logits[0].permute(1, 2, 0).cpu().numpy()


def _bucket_hw(h: int, w: int, mult: int = 32) -> Tuple[int, int]:
    return ((h + mult - 1) // mult * mult, (w + mult - 1) // mult * mult)


def whole_image_logits(infer: Callable, image: np.ndarray) -> np.ndarray:
    """(H, W, C) logits of one (H, W, 3) normalized image, zero-padded
    (zero is the mean pixel) to the next multiple of 32 and cropped back,
    as the JAX package computes them (its seg_loop.py:90-109)."""
    h, w = image.shape[:2]
    bh, bw = _bucket_hw(h, w)
    if (bh, bw) != (h, w):
        image = np.pad(image, ((0, bh - h), (0, bw - w), (0, 0)))
    return _hwc(infer(_nchw(image)))[:h, :w]


def flip_tta(infer: Callable, images: torch.Tensor,
             flip_pairs=None) -> torch.Tensor:
    """Average of the logits of x and of flip(x) flipped back
    (base_dataset.py:155-165); ``flip_pairs`` (left, right) class pairs
    swap their channels when un-flipping (lip.py:107-130)."""
    logits = infer(images)
    flipped = infer(images.flip(3)).flip(3)
    if flip_pairs:
        idx = np.arange(logits.shape[1])
        for left, right in flip_pairs:
            idx[left], idx[right] = idx[right], idx[left]
        flipped = flipped[:, torch.as_tensor(idx, device=flipped.device)]
    return (logits + flipped) * 0.5


def multi_scale_inference(infer: Callable, image: np.ndarray,
                          crop_size: Tuple[int, int], num_classes: int,
                          scales=(1.0,), flip: bool = False,
                          flip_pairs=None) -> np.ndarray:
    """Sliding-window multi-scale (H, W, C) logits of one (H, W, 3)
    normalized image (the JAX package's seg_loop.py:161-200; reference
    base_dataset.py:167-229): every window has the crop size."""
    ori_h, ori_w = image.shape[:2]
    final = np.zeros((ori_h, ori_w, num_classes), np.float32)
    run = (lambda x: flip_tta(infer, x, flip_pairs)) if flip else infer
    for scale in scales:
        new_h = int(ori_h * scale + 0.5)
        new_w = int(ori_w * scale + 0.5)
        scaled = resize_linear(image, new_w, new_h)
        ch, cw = crop_size
        scaled = pad_constant(scaled, ch - new_h, cw - new_w, 0.0)
        hh, ww = scaled.shape[:2]
        rows = int(np.ceil((hh - ch) / ch)) + 1
        cols = int(np.ceil((ww - cw) / cw)) + 1
        preds = np.zeros((hh, ww, num_classes), np.float32)
        count = np.zeros((hh, ww, 1), np.float32)
        for r in range(rows):
            for c in range(cols):
                y1 = min(r * ch + ch, hh)
                x1 = min(c * cw + cw, ww)
                y0, x0 = max(y1 - ch, 0), max(x1 - cw, 0)
                preds[y0:y1, x0:x1] += _hwc(run(_nchw(scaled[y0:y1, x0:x1])))
                count[y0:y1, x0:x1] += 1
        preds = (preds / count)[:new_h, :new_w]
        final += resize_linear(preds, ori_w, ori_h)
    return final


def _image_logits(config, infer, image, num_classes, flip_pairs=None):
    if config.TEST.MULTI_SCALE or config.TEST.FLIP_TEST:
        crop = (config.TEST.IMAGE_SIZE[1], config.TEST.IMAGE_SIZE[0])
        return multi_scale_inference(
            infer, image, crop, num_classes, scales=config.TEST.SCALE_LIST,
            flip=config.TEST.FLIP_TEST, flip_pairs=flip_pairs)
    return whole_image_logits(infer, image)


def seg_validate(config, loader, model) -> Tuple[float, float, np.ndarray]:
    """Validation loss and mIoU over crop-sized batches (reference
    function.py:658-705)."""
    infer = make_infer_fn(model)
    confusion = np.zeros((config.DATASET.NUM_CLASSES,) * 2)
    losses = []
    for images, labels, _, _ in loader:
        logits = infer(images)
        labels = labels.to(logits.device)
        losses.append(float(cross_entropy_loss(
            logits, labels, config.TRAIN.IGNORE_LABEL)))
        confusion += get_confusion_matrix(
            labels.cpu().numpy(), logits.cpu().numpy(),
            config.DATASET.NUM_CLASSES, config.TRAIN.IGNORE_LABEL)
    mean_iou, iou_array = miou_from_confusion(confusion)
    return float(np.mean(losses)), float(mean_iou), iou_array


def seg_testval(config, dataset, model, sv_dir: str = "",
                sv_pred: bool = False):
    """Whole-test-set mIoU, pixel accuracy and mean accuracy, with optional
    multi-scale + flip TTA (reference function.py:708-757)."""
    infer = make_infer_fn(model)
    num_classes = config.DATASET.NUM_CLASSES
    confusion = np.zeros((num_classes, num_classes))
    for index in range(len(dataset)):
        image, label, _, name = dataset[index]
        logits = _image_logits(config, infer, image, num_classes,
                               getattr(dataset, "flip_pairs", None))
        if logits.shape[:2] != label.shape:
            logits = resize_linear(logits, label.shape[1], label.shape[0])
        confusion += get_confusion_matrix(
            label[None], logits.transpose(2, 0, 1)[None], num_classes,
            config.TRAIN.IGNORE_LABEL)
        if sv_pred and sv_dir:
            sv_path = os.path.join(sv_dir, "test_val_results")
            os.makedirs(sv_path, exist_ok=True)
            dataset.save_pred(logits[None], sv_path, [name])
        if index % 100 == 0:
            mean_iou, _ = miou_from_confusion(confusion)
            logger.info("processing: %d images, mIoU %.4f", index, mean_iou)
    pos = confusion.sum(1)
    tp = np.diag(confusion)
    pixel_acc = tp.sum() / pos.sum()
    mean_acc = (tp / np.maximum(1.0, pos)).mean()
    mean_iou, iou_array = miou_from_confusion(confusion)
    return mean_iou, iou_array, pixel_acc, mean_acc


def seg_test(config, dataset, model, sv_dir: str) -> None:
    """Label-free prediction dump (reference function.py:759-780)."""
    infer = make_infer_fn(model)
    num_classes = config.DATASET.NUM_CLASSES
    sv_path = os.path.join(sv_dir, "test_results")
    os.makedirs(sv_path, exist_ok=True)
    for index in range(len(dataset)):
        image, size, name = dataset[index]
        logits = _image_logits(config, infer, image, num_classes)
        if logits.shape[:2] != tuple(size[:2]):
            logits = resize_linear(logits, int(size[1]), int(size[0]))
        dataset.save_pred(logits[None], sv_path, [name])
