"""Hand-written Hopper kernels of the port, one module per TPU kernel of
:mod:`repro.kernels`.

Each module holds the wrapper (checks device, dtype, shape and contiguity;
launches the CUDA kernel for a CUDA tensor, runs the plain PyTorch version
for a CPU tensor, raises otherwise), the plain version, and a ``LAUNCHES``
counter.  The CUDA sources live in ``repro_torch/csrc`` and are built on
first use by :mod:`repro_torch.kernels.build`.

===============  ==========================================  ================
module           replaces (TPU kernel)                       backs
===============  ==========================================  ================
seg_sum          ``repro/kernels/seg_sum.py``                flat_profile
pair_sum         ``repro/kernels/pair_sum.py``               comm_matrix,
                                                             load_imbalance,
                                                             flat_profile
                                                             (per_process)
time_bin         ``repro/kernels/time_bin.py``               time_profile
hist_bin         ``repro/kernels/hist_bin.py``               message_histogram
flash_attention  ``repro/kernels/flash_attention.py``        LM prefill and
                 (forward); its backward kernel              training
                 (``flash_attention_bwd``) replaces none:    attention
                 the TPU kernel is forward-only
topk_gating      ``repro/kernels/topk_gating.py``            MoE routing
                 (forward); its backward kernel              (float32), and
                 (``topk_gating_bwd``) replaces none:        the router's
                 the TPU kernel is forward-only              backward on
                                                             both routes
router_topk      ``repro/kernels/topk_gating.py`` fused      MoE routing
                 with the router product of                  (bfloat16)
                 ``repro/models/moe.py``
===============  ==========================================  ================
"""

from . import (flash_attention, hist_bin, pair_sum, router_topk, seg_sum,
               time_bin, topk_gating)

#: the kernels of the trace-analysis path, in the order it first reaches them
TRACE_KERNELS = (seg_sum, pair_sum, time_bin, hist_bin)
#: the kernels of the LM serving path (bfloat16 weights route through
#: router_topk; float32 ones through topk_gating); the training path runs
#: flash_attention's forward and backward kernels and, in an MoE model,
#: the router's forward and topk_gating's backward kernel
MODEL_KERNELS = (flash_attention, router_topk, topk_gating)
#: every kernel module
KERNELS = TRACE_KERNELS + MODEL_KERNELS

__all__ = ["KERNELS", "TRACE_KERNELS", "MODEL_KERNELS", "seg_sum",
           "pair_sum", "time_bin", "hist_bin", "flash_attention",
           "router_topk", "topk_gating"]
