"""idle_share.train: the share of three profiled training steps in which
the device ran nothing, 100 (1 - busy / wall), one stream."""


def read(table, layer):
    if table is None or "steps" not in layer:
        return None
    return 100.0 * (1.0 - table.busy_s() / table.wall_s)
