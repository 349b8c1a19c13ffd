"""One reader a per-layer metric, named as in ``BENCHMARK.json``:
``read(table, layer)`` takes the traced stretch's ``devtrace.Table`` (or
None) and the kind's ``layer`` dict, and returns the metric's value,
or None where the run has nothing for it to read."""
