"""One module a kind of cell (``"kind"`` in ``workloads/<cell>.json``):
``run(Run) -> Outcome``."""
