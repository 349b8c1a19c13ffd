"""launches_per_step.train: device kernels (copies and sets left out) in
the profiled steps, per step."""


def read(table, layer):
    if table is None or "steps" not in layer:
        return None
    return len(table.kernels()) / layer["profiled_steps"]
