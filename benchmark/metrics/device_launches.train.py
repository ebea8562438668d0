"""device_launches.train: device activities (kernels, copies, sets) that
start inside the traced sub-window, per unit (a step or a test clip)."""

KIND = "train"


def read(ctx):
    t = ctx["trace"]
    if not t or ctx["work"].get("kind") != KIND:
        return None
    return t["launches"] / t["units"]
