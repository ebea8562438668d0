"""train_device_ms_per_sample: the device's busy time over the whole
measured window (the union of its kernels', copies' and sets' intervals,
from a trace of device activity over every step of the window) per sample
trained (clip triples or crops of its whole steps), in ms."""


def read(ctx):
    w, t = ctx["work"], ctx.get("window_trace")
    if w.get("kind") != "train" or not t or t["busy_s"] <= 0 or not w["samples"]:
        return None
    return 1e3 * t["busy_s"] / w["samples"]
