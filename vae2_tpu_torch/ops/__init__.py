"""Ops: fused BN + activation (CUDA kernel), resizing, image metrics."""
