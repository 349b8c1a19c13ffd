"""cardbench: the benchmark of the PyTorch and CUDA port (``repro_torch``)
on one NVIDIA H100.  ``run.py`` is the entry point; its docstring says how
to run a cell and how to add one."""
