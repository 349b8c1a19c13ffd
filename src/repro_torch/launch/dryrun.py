"""Multi-pod dry run: run every (architecture × shape) cell's step once on
the production mesh with no devices, and record per-device memory, FLOPs,
HBM bytes and collectives, and the three-term roofline on the H100's
table.

Mirrors :mod:`repro.launch.dryrun` (same CLI, ``SKIP`` set and record
keys)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape decode_32k [--multi-pod] [--out experiments/dryrun_torch]

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference compiles each cell for 256 or 512 fake XLA CPU devices and
reads XLA's cost analysis.  The port runs the cell's eager step instead:

* a ``"fake"`` process group of 256 or 512 ranks
  (``torch.testing._internal.distributed.fake_pg``) under the named
  ``DeviceMesh`` of :func:`repro_torch.launch.mesh.make_production_mesh`;
  this process plays rank 0 and its collectives move nothing;
* the model's parameters, optimizer state, batch and cache built under
  ``FakeTensorMode`` (shapes and dtypes, no storage) and placed as
  DTensors by :func:`repro_torch.launch.steps.build_cell`; the model takes
  its kernels' plain versions (nothing is launched or timed);
* :class:`DeviceCounter`, a dispatch mode that sees every operation on
  the local shards (it hands DTensor operations back to DTensor, whose
  dispatch then runs them on the shards): FLOPs by
  ``torch.utils.flop_counter``'s formulas, HBM bytes as each operation's
  input and output bytes (views, allocations and collectives excluded),
  live bytes of the local storages for the peak, and each collective's
  wire bytes by :func:`repro_torch.analysis.hlostats.wire_bytes`' ring
  factors, with ``CommDebugMode``'s count beside.  ``FlopCounterMode``
  alone reports *global* FLOPs under DTensor (it sees the DTensor-level
  operations on their global shapes; the tests pin this on two
  matmuls), so it is not used for the per-device count.

The reference's cost probes (two more compiles with unrolled scans, to
undo XLA's counting a ``scan`` body once) have no counterpart: the port
runs every layer, so its counts cover every layer as run.  ``--save-hlo``
has no counterpart either (no HLO is made) and raises.  On this CPU
mesh DTensor turns an all-to-all into an all-gather (gloo and the fake
group have none), so that is what the schedule prices.  The numbers are
a model of a step, not a measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..analysis.hlostats import summarize
from ..analysis.roofline import HW_H100, roofline_terms
from ..configs import ARCH_NAMES, get_config
from ..models.config import SHAPES
from .mesh import make_production_mesh
from .steps import build_cell

__all__ = ["SKIP", "DeviceCounter", "run_cell", "fake_world", "main"]

SKIP = {
    # long_500k needs a bounded cache: pure full-attention archs are
    # excluded, as in the reference
    ("whisper-medium", "long_500k"),
    ("qwen2-moe-a2.7b", "long_500k"),
    ("qwen3-moe-235b-a22b", "long_500k"),
    ("qwen1.5-110b", "long_500k"),
    ("qwen1.5-0.5b", "long_500k"),
    ("codeqwen1.5-7b", "long_500k"),
    ("phi-3-vision-4.2b", "long_500k"),
}

_COLL = {"all_gather_into_tensor": "all-gather",
         "all_reduce": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "detach", "alias",
               "lift_fresh")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    """Every tensor in ``x``: nested lists, tuples, dicts and dataclasses
    (the AdamW state)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if dataclasses.is_dataclass(x):
        return _tensors([getattr(x, f.name) for f in dataclasses.fields(x)])
    return []


class DeviceCounter(TorchDispatchMode):
    """Per-device counts of the operations on local shards (see the module
    docstring).  DTensor derives each new operation's output shape by
    running it once on fake tensors of the global shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``); while the counter is on, that
    method is wrapped so that what it runs is not counted."""

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collectives: List[Tuple[str, float, float, int]] = []
        self.base_bytes = base_bytes
        self.live = base_bytes
        self.peak = base_bytes
        self._seen = set()
        self._in_prop = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        inner = SP._propagate_tensor_meta_non_cached
        counter = self

        def shapes_only(prop, op_schema):
            counter._in_prop += 1
            try:
                return inner(prop, op_schema)
            finally:
                counter._in_prop -= 1
        self._restore = (SP, inner)
        SP._propagate_tensor_meta_non_cached = shapes_only
        return super().__enter__()

    def __exit__(self, *exc):
        SP, inner = self._restore
        SP._propagate_tensor_meta_non_cached = inner
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._in_prop:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in ("_c10d_functional", "c10d_functional"):
            self._collective(name, args, ins, outs)
            for t in outs:
                self._track(t)
            return out
        if func.is_view or ns == "prim":
            return out
        fl = flop_registry.get(func._overloadpacket)
        if fl is not None:
            self.flops += int(fl(*args, **kwargs, out_val=out))
        if name not in _NO_TRAFFIC:
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def _collective(self, name, args, ins, outs) -> None:
        kind = _COLL.get(name)
        if kind is None:
            return                       # wait_tensor and the like
        from torch.distributed.distributed_c10d import _resolve_process_group
        op_b = float(sum(_nbytes(t) for t in ins))
        res_b = float(sum(_nbytes(t) for t in outs))
        g = _resolve_process_group(args[-1]).size()
        self.collectives.append((kind, res_b, op_b, g))


def fake_world(chips: int) -> None:
    """Make the default process group a ``"fake"`` one of ``chips``
    ranks (this process rank 0), replacing another."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == chips and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)


def _local_bytes(x) -> int:
    from torch.distributed.tensor import DTensor
    seen, n = set(), 0
    for t in _tensors(x):
        loc = t.to_local() if isinstance(t, DTensor) else t
        st = loc.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             save_hlo: bool = False, overrides=None) -> dict:
    """One cell's step run once on the fake production mesh; returns (and
    under ``out_dir`` writes) its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    if save_hlo:
        raise ValueError("--save-hlo: the port's dry run runs a torch step "
                         "and makes no HLO module to save")
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"

    fake = FakeTensorMode()
    t0 = time.time()
    with fake:
        cell = build_cell(cfg, shape, mesh)
        args = cell.make_args()
        arg_b = _local_bytes(args)
        counter = DeviceCounter(base_bytes=arg_b)
        with CommDebugMode() as comm, counter:
            out = cell.fn(*args)
        out_b = _local_bytes(out)
    t_run = time.time() - t0

    coll = summarize(counter.collectives)
    coll["comm_debug_count"] = int(comm.get_total_counts())
    flops, hbm = float(counter.flops), float(counter.hbm_bytes)
    wire = coll["total"]["wire_bytes"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cell.meta["active_params"]
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    rl = roofline_terms(flops * chips, hbm * chips, wire, chips,
                        model_flops, hw=HW_H100)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "kind": shape.kind, "n_periods": cfg.n_layers,
        # the step's build and run (the port compiles nothing), no probes
        "compile_s": round(t_run, 2), "probe_s": 0.0,
        "params": cell.meta["params"], "active_params": n_active,
        "memory_analysis": {
            "argument_size": arg_b, "output_size": out_b,
            "temp_size": counter.peak - arg_b, "peak_size": counter.peak,
        },
        # per device, under XLA's cost-analysis names
        "cost_analysis_raw": {"flops": flops, "bytes accessed": hbm},
        "per_device": {"flops": flops, "hbm_bytes": hbm,
                       "wire_bytes": wire},
        "collectives_schedule": coll,
        "roofline": rl,
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in cell.meta["rules"].items()},
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        base = f"{arch}__{shape_name}__{mesh_name}"
        with open(os.path.join(out_dir, base + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="no counterpart in the port: raises")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port's dry run runs a torch step and "
                 "makes no HLO module to save")

    cells = []
    if args.all:
        for a in ARCH_NAMES:
            if a == "pipit-lm-100m":
                continue
            for s in SHAPES:
                if (a, s) not in SKIP:
                    cells.append((a, s))
    else:
        cells = [(args.arch, args.shape)]

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    failures = []
    for arch, shape in cells:
        base = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
        if args.skip_existing and os.path.exists(base):
            print(f"[skip] {arch} {shape} (exists)")
            continue
        try:
            r = run_cell(arch, shape, args.multi_pod, args.out)
            rl = r["roofline"]
            print(f"[ok] {arch:22s} {shape:12s} {mesh_name} "
                  f"run={r['compile_s']:.1f}s "
                  f"compute={rl['compute_s']:.3e}s mem={rl['memory_s']:.3e}s "
                  f"coll={rl['collective_s']:.3e}s → {rl['bottleneck']}",
                  flush=True)
        except Exception as e:
            failures.append((arch, shape, repr(e)))
            print(f"[FAIL] {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("dry-run complete.")


if __name__ == "__main__":
    main()
