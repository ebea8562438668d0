"""score_share.sample: device time of the activities inside the
benchmark's ``bench.score`` spans (the frame scores of
``make_metric_fn``) over all device time of the traced sub-window, in %."""


def read(ctx):
    t = ctx["trace"]
    if not t or ctx["work"].get("kind") != "sample" or t["device_s"] <= 0:
        return None
    return 100.0 * t["span_device_s"].get("bench.score", 0.0) / t["device_s"]
