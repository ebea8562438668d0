"""train_samples_per_s: samples (clip triples or crops) of the whole steps
of the window over the window's seconds, to the end of the last step."""


def read(ctx):
    w = ctx["work"]
    return w["samples"] / w["seconds"] if w.get("kind") == "train" else None
