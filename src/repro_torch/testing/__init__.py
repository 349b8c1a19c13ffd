"""Test-support utilities shipped with the port (mirrors
:mod:`repro.testing`).

``repro_torch.testing.faults`` is the fault-injection harness:
deterministic file corruptors (truncate / bit-flip / garbage append / torn
footer) and service-level injectors (a TCP fault proxy, flaky handle
opens) used by the robustness tests and by
``python -m repro_torch.launch.crash_smoke``.
"""
