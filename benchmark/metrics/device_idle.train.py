"""device_idle.train: the share of the traced sub-window (whole units) in
which no device activity ran: 1 - the union of the kernels', copies' and
sets' intervals over the sub-window, in %."""

KIND = "train"


def read(ctx):
    t = ctx["trace"]
    if not t or ctx["work"].get("kind") != KIND:
        return None
    return 100.0 * t["idle_share"]
