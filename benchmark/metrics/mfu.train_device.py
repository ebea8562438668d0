"""mfu.train_device: the model FLOPs of a step (forward and backward, no
recompute, counted from the reference at the cell's shapes: ``flops`` in
the cell's workload file) times the traced steps, over the device's busy
time in them and the card's bf16 dense peak, in %."""


def read(ctx):
    t, peaks = ctx["trace"], ctx["peaks"]
    if not t or not peaks or ctx["work"].get("kind") != "train" or t["busy_s"] <= 0:
        return None
    flops = ctx["workload"]["counts"]["flops"]
    return 100.0 * flops * t["units"] / t["busy_s"] / peaks["bf16_flops"]
