"""flash_bwd_roofline: the least time the profiled steps' flash-attention
backward calls could take on the H100 (each layer's call at the step's
[batch, seq, heads, head dim], causal; counts.flash_bwd) over the device
time of the backward's kernels (bwd_delta, bwd_dkdv*, bwd_dq*)."""

from cardbench import counts

KERNELS = ("bwd_delta", "bwd_dkdv", "bwd_dq")


def read(table, layer):
    if table is None or "steps" not in layer:
        return None
    a = layer["arch"]
    t = sum(e - s for n, s, e in table.kernels()
            if any(k in n for k in KERNELS))
    if t <= 0:
        return None
    one = counts.bound_s(*counts.flash_bwd(layer["batch"], layer["seq"],
                                           a.heads, a.kv_heads, a.hd))
    return 100.0 * one * a.layers * layer["profiled_steps"] / t
