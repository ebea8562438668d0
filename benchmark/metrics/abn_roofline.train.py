"""abn_roofline.train: the least time the identity-activation BNs' work of a
unit could take on the card (the larger of its bytes over HBM's rate and
its operations over the f32 peak; abn_bytes and abn_ops of the
cell's workload file, counted from the reference's BN shapes: each input
read once, each output written once, no recompute) over the device time of
the kernels that do it in the traced sub-window, per unit, in %."""

KIND = "train"
KERNELS = ("abn_fwd_kernel", "abn_bwd_sums_kernel", "abn_bwd_dx_kernel")


def read(ctx):
    t, peaks = ctx["trace"], ctx["peaks"]
    if not t or not peaks or ctx["work"].get("kind") != KIND:
        return None
    seconds = sum(s for name, s in t["by_name"].items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    c = ctx["workload"]["counts"]
    bound = max(c["abn_bytes"] / peaks["hbm_bytes_per_s"], c["abn_ops"] / peaks["f32_flops"])
    return 100.0 * bound * t["units"] / seconds
