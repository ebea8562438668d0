"""Data pipeline: clip datasets, threaded decode, on-device normalization."""
