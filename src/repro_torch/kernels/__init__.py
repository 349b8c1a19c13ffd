"""Hand-written Hopper kernels of the port, one module per TPU kernel of
:mod:`repro.kernels` on the trace-analysis path.

Each module holds the wrapper (checks device, dtype, shape and contiguity;
launches the CUDA kernel for a CUDA tensor, runs the plain PyTorch version
for a CPU tensor, raises otherwise), the plain version, and a ``LAUNCHES``
counter.  The CUDA sources live in ``repro_torch/csrc`` and are built on
first use by :mod:`repro_torch.kernels.build`.

==========  ====================================  ==========================
module      replaces (TPU kernel)                 backs
==========  ====================================  ==========================
seg_sum     ``repro/kernels/seg_sum.py``          flat_profile
pair_sum    ``repro/kernels/pair_sum.py``         comm_matrix,
                                                  load_imbalance,
                                                  flat_profile(per_process)
time_bin    ``repro/kernels/time_bin.py``         time_profile
hist_bin    ``repro/kernels/hist_bin.py``         message_histogram
==========  ====================================  ==========================
"""

from . import hist_bin, pair_sum, seg_sum, time_bin

#: every kernel module, in the order the main path first reaches them
KERNELS = (seg_sum, pair_sum, time_bin, hist_bin)

__all__ = ["KERNELS", "seg_sum", "pair_sum", "time_bin", "hist_bin"]
