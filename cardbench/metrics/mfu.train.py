"""mfu.train: the model's operations in the window's steps (6 x the
active matrix parameters x tokens, the head, causal attention; an MoE
counts its k chosen experts) over the window's wall time, as a share of
989 TFLOP/s bf16."""

from cardbench import counts


def read(table, layer):
    if "steps" not in layer or not layer["steps"]:
        return None
    rate = layer["flops_per_step"] * layer["steps"] / layer["window_s"]
    return 100.0 * rate / counts.BF16_FLOPS
