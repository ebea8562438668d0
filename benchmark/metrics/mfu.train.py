"""mfu.train: the model FLOPs of a step (forward and backward, no
recompute, counted from the reference at the cell's shapes: ``flops`` in
the cell's workload file) times the window's steps, over the window's
seconds and the card's bf16 dense peak, in %."""


def read(ctx):
    w, peaks = ctx["work"], ctx["peaks"]
    if w.get("kind") != "train" or not peaks or not ctx["trace"]:
        return None
    flops = ctx["workload"]["counts"]["flops"]
    return 100.0 * flops * w["attempted"] / w["seconds"] / peaks["bf16_flops"]
