"""sample_frames_per_s: predicted frames of the test clips that were
sampled and scored completely in the window (9 a sample: x1p, x2p, x3p)
over the window's seconds."""


def read(ctx):
    w = ctx["work"]
    return w["frames"] / w["seconds"] if w.get("kind") == "sample" else None
