"""mfu.sample: the model FLOPs of a test clip (the encoder prefix once,
the samples kept through the rest, their scores; counted from the
reference: ``flops`` in the cell's workload file) times the window's
clips, over the window's seconds and the card's bf16 dense peak, in %."""


def read(ctx):
    w, peaks = ctx["work"], ctx["peaks"]
    if w.get("kind") != "sample" or not peaks or not ctx["trace"]:
        return None
    flops = ctx["workload"]["counts"]["flops"]
    return 100.0 * flops * w["attempted"] / w["seconds"] / peaks["bf16_flops"]
