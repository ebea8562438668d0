"""mfu.train_ddp: the model FLOPs of a rank's step (forward and backward, no
recompute, counted from the reference at the cell's shapes: ``flops`` in
the cell's workload file) times the traced steps, over a card's device
time in them as ``ddp_device_ms_per_sample`` takes it (the mean over the
cards of the busy time outside NCCL's kernels, plus the collectives' own
time) and the card's bf16 dense peak, in %. A rank's own reading, before
rank 0 merges them, is its parts."""

from benchmark import trace

NAME = "mfu.train_ddp"


def read(ctx):
    t, peaks = ctx["trace"], ctx["peaks"]
    if "ranks" in ctx:
        parts = [r.get(NAME) for r in ctx["ranks"]]
        if None in parts or not t or not peaks:
            return None
        exchange = trace.exchange_s(p["collective_ns"] for p in parts)
        other = sum(p["other_busy_s"] for p in parts) / len(parts)
        if exchange is None or other <= 0:
            return None
        flops = ctx["workload"]["counts"]["flops"]
        return 100.0 * flops * t["units"] / (other + exchange) / peaks["bf16_flops"]
    if not t or ctx["work"].get("kind") != "train" or "collective_ns" not in t:
        return None
    return {"other_busy_s": t["other_busy_s"], "collective_ns": t["collective_ns"]}
