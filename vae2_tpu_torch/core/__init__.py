"""Inference engine: system, builder, metrics, the prior-sampling loop."""
