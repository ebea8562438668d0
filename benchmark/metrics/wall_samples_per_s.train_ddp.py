"""wall_samples_per_s.train_ddp: train_samples_per_s by the host's clock
(the global batch's clip triples of the window's whole steps over the
window's seconds on rank 0's clock: what a user's run of several cards
feels), per layer where it is not an end-to-end metric: the window of a
``--trace 1`` run is not traced (its profiled units come after it). Four
hosts dispatch in lockstep, so it swings with the slowest of them from run
to run."""

from pathlib import Path

from benchmark import manifest

read = manifest.reader("train_samples_per_s", Path(__file__).resolve().parents[1]).read
