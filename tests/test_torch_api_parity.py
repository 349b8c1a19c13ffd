"""Every public name of the reference has a counterpart in the port.

The test walks every module of ``src/repro`` and holds the module of the
same dotted path under ``src/repro_torch`` to it:

* each name in the module's ``__all__``;
* each public class the module defines, and each public method of it (a
  callable, property, class or static method in the class's own
  ``__dict__``), with every named parameter, and ``**kwargs`` where the
  reference takes them;
* each public function the module defines, with every named parameter,
  and ``*args`` / ``**kwargs`` where the reference takes them.

What the port lacks on purpose is listed in :data:`BY_DESIGN`, each entry
a gap as the walk names it, mapped to its reason and to the port's
counterpart (a dotted name the test resolves).  The dict is checked both
ways: a gap with no entry fails, and so does an entry the port now fills.
Four modules of the reference are excluded whole, with ROADMAP A's
reasons (:data:`EXCLUDED_MODULES`); no other module is.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import pkgutil
import warnings

import pytest

import repro

_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)

#: reference modules with no port module of their own
EXCLUDED_MODULES = {
    "repro.kernels.ops": "the Pallas kernels' jit entry points; the "
                         "port's kernels/*.py wrappers are its entry points",
    "repro.kernels.ref": "the kernels' pure-JAX references; each port "
                         "wrapper keeps its plain PyTorch version beside "
                         "it (seg_sum_plain, ...)",
    "repro.testing.hyp": "property-test strategies; the port's tests "
                         "import the reference's",
    "repro.testing.minihyp": "the reference's fallback for a missing "
                             "hypothesis; the port's tests import it",
}

_NO_BACKEND = ("no backend table: each op runs its kernel on the device= "
               "it is given (the card unless the caller asks for the CPU)")
_PALLAS_TILE = ("a Pallas grid's block size and interpret mode; the CUDA "
                "kernel picks its own tiling from N, and a CPU tensor runs "
                "the plain version")
_MODULE_PARAMS = ("the model is an nn.Module: it holds its parameters, so "
                  "no params argument is passed")
_XLA_SCAN = ("an XLA scan's chunk and unroll; the port's attention is one "
             "flash kernel launch with its own tiles")

#: gap -> (reason, the port's counterpart)
BY_DESIGN = {
    # the backend table (ROADMAP north star: device= replaces it)
    "ALL repro.core.register_backend":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "ALL repro.core.get_backend":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "ALL repro.core.op_backends":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "ALL repro.core.list_backends":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "ALL repro.core.registry.register_backend":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "ALL repro.core.registry.get_backend":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "ALL repro.core.registry.op_backends":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "ALL repro.core.registry.list_backends":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "FUNC repro.core.registry.register_backend":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "FUNC repro.core.registry.get_backend":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "FUNC repro.core.registry.op_backends":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "FUNC repro.core.registry.list_backends":
        (_NO_BACKEND, "repro_torch.core.accel.resolve_device"),
    "METHOD repro.core.registry.OpSpec.backends":
        (_NO_BACKEND, "repro_torch.core.registry.OpSpec"),
    "FUNC repro.core.ops_summary.register_time_profile_backend":
        (_NO_BACKEND, "repro_torch.kernels.time_bin.time_bin"),
    "PARAM repro.core.ops_summary.flat_profile(backend)":
        (_NO_BACKEND, "repro_torch.core.ops_summary.flat_profile"),
    "PARAM repro.core.ops_summary.time_profile(backend)":
        (_NO_BACKEND, "repro_torch.core.ops_summary.time_profile"),
    "PARAM repro.core.ops_summary.load_imbalance(backend)":
        (_NO_BACKEND, "repro_torch.core.ops_summary.load_imbalance"),
    "PARAM repro.core.ops_comm.comm_matrix(backend)":
        (_NO_BACKEND, "repro_torch.core.ops_comm.comm_matrix"),
    "PARAM repro.core.ops_comm.message_histogram(backend)":
        (_NO_BACKEND, "repro_torch.core.ops_comm.message_histogram"),
    "PARAM repro.core.detectors.stragglers(backend)":
        (_NO_BACKEND, "repro_torch.core.detectors.stragglers"),
    "MPARAM repro.core.trace.Trace.flat_profile(backend)":
        (_NO_BACKEND, "repro_torch.core.trace.Trace.flat_profile"),
    "MPARAM repro.core.trace.Trace.time_profile(backend)":
        (_NO_BACKEND, "repro_torch.core.trace.Trace.time_profile"),
    "MPARAM repro.core.trace.Trace.comm_matrix(backend)":
        (_NO_BACKEND, "repro_torch.core.trace.Trace.comm_matrix"),
    "MPARAM repro.core.trace.Trace.message_histogram(backend)":
        (_NO_BACKEND, "repro_torch.core.trace.Trace.message_histogram"),
    "MPARAM repro.core.trace.Trace.load_imbalance(backend)":
        (_NO_BACKEND, "repro_torch.core.trace.Trace.load_imbalance"),
    # the Pallas kernels' grid and interpret arguments
    "PARAM repro.kernels.seg_sum.seg_sum(be)":
        (_PALLAS_TILE, "repro_torch.kernels.seg_sum.path"),
    "PARAM repro.kernels.seg_sum.seg_sum(interpret)":
        (_PALLAS_TILE, "repro_torch.kernels.seg_sum.seg_sum_plain"),
    "PARAM repro.kernels.pair_sum.pair_sum(be)":
        (_PALLAS_TILE, "repro_torch.kernels.pair_sum.path"),
    "PARAM repro.kernels.pair_sum.pair_sum(interpret)":
        (_PALLAS_TILE, "repro_torch.kernels.pair_sum.pair_sum_plain"),
    "PARAM repro.kernels.time_bin.time_bin(be)":
        (_PALLAS_TILE, "repro_torch.kernels.time_bin.path"),
    "PARAM repro.kernels.time_bin.time_bin(interpret)":
        (_PALLAS_TILE, "repro_torch.kernels.time_bin.time_bin_plain"),
    "PARAM repro.kernels.hist_bin.hist_bin(be)":
        (_PALLAS_TILE, "repro_torch.kernels.hist_bin.path"),
    "PARAM repro.kernels.hist_bin.hist_bin(interpret)":
        (_PALLAS_TILE, "repro_torch.kernels.hist_bin.hist_bin_plain"),
    "PARAM repro.kernels.topk_gating.topk_gating(bt)":
        (_PALLAS_TILE, "repro_torch.kernels.topk_gating.path"),
    "PARAM repro.kernels.topk_gating.topk_gating(interpret)":
        (_PALLAS_TILE, "repro_torch.kernels.topk_gating.topk_gating_plain"),
    "PARAM repro.kernels.flash_attention.flash_attention(bq)":
        (_PALLAS_TILE, "repro_torch.kernels.flash_attention.variant"),
    "PARAM repro.kernels.flash_attention.flash_attention(bk)":
        (_PALLAS_TILE, "repro_torch.kernels.flash_attention.variant"),
    "PARAM repro.kernels.flash_attention.flash_attention(interpret)":
        (_PALLAS_TILE,
         "repro_torch.kernels.flash_attention.flash_attention_plain"),
    # XLA scans
    "PARAM repro.models.attention.chunked_attention(chunk)":
        (_XLA_SCAN, "repro_torch.models.attention.chunked_attention"),
    "PARAM repro.models.attention.chunked_attention(unroll)":
        (_XLA_SCAN, "repro_torch.models.attention.chunked_attention"),
    "PARAM repro.models.attention.local_attention(chunk)":
        (_XLA_SCAN, "repro_torch.models.attention.local_attention"),
    "PARAM repro.models.attention.local_attention(unroll)":
        (_XLA_SCAN, "repro_torch.models.attention.local_attention"),
    "PARAM repro.models.ssm.ssd_chunked(unroll)":
        ("an XLA scan's unroll; the port loops over the chunks in Python",
         "repro_torch.models.ssm.ssd_chunked"),
    "PARAM repro.models.blocks.cache_defs(ring)":
        ("the reference's model only ever passes ring=True; the port's "
         "cache_defs is that form", "repro_torch.models.blocks.cache_defs"),
    # the functional model as an nn.Module
    "MPARAM repro.models.lm.LM.forward(params)":
        (_MODULE_PARAMS, "repro_torch.models.lm.LM.forward"),
    "MPARAM repro.models.lm.LM.prefill(params)":
        (_MODULE_PARAMS, "repro_torch.models.lm.LM.prefill"),
    "MPARAM repro.models.lm.LM.decode_step(params)":
        (_MODULE_PARAMS, "repro_torch.models.lm.LM.decode_step"),
    "MPARAM repro.models.lm.LM.loss(params)":
        (_MODULE_PARAMS, "repro_torch.models.lm.LM.loss"),
    "MPARAM repro.models.lm.LM.loss(batch)":
        ("the batch's keys are loss's own arguments: loss(tokens, labels, "
         "**extras); the trainer unpacks the batch",
         "repro_torch.runtime.trainer.Trainer"),
    "MPARAM repro.models.lm.LM.init(key)":
        ("an nn.Module's parameters are allocated at construction; init "
         "draws them in place from a torch.Generator",
         "repro_torch.models.lm.LM.init"),
    "MPARAM repro.models.lm.LM.init(dtype)":
        ("the dtype is the module's, fixed at construction: LM(cfg, dtype, "
         "device)", "repro_torch.models.lm.LM"),
    "MPARAM repro.models.encdec.EncDecLM.encode(params)":
        (_MODULE_PARAMS, "repro_torch.models.encdec.EncDecLM.encode"),
    "MPARAM repro.models.encdec.EncDecLM.forward(params)":
        (_MODULE_PARAMS, "repro_torch.models.encdec.EncDecLM.forward"),
    "MPARAM repro.models.encdec.EncDecLM.prefill(params)":
        (_MODULE_PARAMS, "repro_torch.models.encdec.EncDecLM.prefill"),
    "MPARAM repro.models.encdec.EncDecLM.loss(params)":
        (_MODULE_PARAMS, "repro_torch.models.encdec.EncDecLM.loss"),
    "MPARAM repro.models.encdec.EncDecLM.loss(batch)":
        ("the batch's keys are loss's own arguments: loss(tokens, labels, "
         "frames=...)", "repro_torch.models.encdec.EncDecLM.loss"),
    # jax's collectives over a named axis
    "PARAM repro.distributed.compression.compressed_psum(axis_name)":
        ("a named shard_map axis; the port reduces over a process group",
         "repro_torch.distributed.compression.compressed_psum"),
    "PARAM repro.distributed.compression.pairwise_compressed_mean(axis_name)":
        ("a named shard_map axis; the port reduces over a process group",
         "repro_torch.distributed.compression.pairwise_compressed_mean"),
    "ALL repro.distributed.sharding.shard_map_compat":
        ("jax API churn around shard_map; the port's manual pod axis is a "
         "process subgroup", "repro_torch.distributed.sharding"),
    "FUNC repro.distributed.sharding.shard_map_compat":
        ("jax API churn around shard_map; the port's manual pod axis is a "
         "process subgroup", "repro_torch.distributed.sharding"),
}


@functools.lru_cache(maxsize=None)
def _ref_modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro.__path__,
                                                        "repro."))


REF_MODULES = [m for m in _ref_modules() if m not in EXCLUDED_MODULES]


def _port_name(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


def _import(name: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return importlib.import_module(name)


def _params(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


def _param_gaps(ref_fn, port_fn, tag: str, where: str):
    """The reference's named parameters the port lacks, and its varargs
    kinds the port does not take."""
    ps, pps = _params(ref_fn), _params(port_fn)
    if ps is None or pps is None:
        return []
    out = []
    for p in ps.values():
        if p.kind in _VAR:
            if not any(q.kind is p.kind for q in pps.values()):
                out.append(f"{tag}VAR {where}({p.name})")
        elif p.name not in pps:
            out.append(f"{tag}PARAM {where}({p.name})")
    return out


def gaps(name: str):
    """Every public name or parameter of reference module ``name`` that
    its port module lacks, as ``KIND dotted.name`` strings."""
    ref = _import(name)
    try:
        port = _import(_port_name(name))
    except ImportError:
        return [f"MODULE {name}"]
    out = [f"ALL {name}.{n}" for n in getattr(ref, "__all__", ())
           if not hasattr(port, n)]
    for n, obj in vars(ref).items():
        if n.startswith("_") or getattr(obj, "__module__", None) != name:
            continue
        pobj = getattr(port, n, None)
        if inspect.isclass(obj):
            if pobj is None:
                out.append(f"CLASS {name}.{n}")
                continue
            for m, v in vars(obj).items():
                if m.startswith("_") or not (
                        callable(v) or isinstance(
                            v, (property, classmethod, staticmethod))):
                    continue
                if not hasattr(pobj, m):
                    out.append(f"METHOD {name}.{n}.{m}")
                    continue
                out += _param_gaps(getattr(obj, m), getattr(pobj, m), "M",
                                   f"{name}.{n}.{m}")
        elif inspect.isfunction(obj):
            if pobj is None:
                out.append(f"FUNC {name}.{n}")
                continue
            out += _param_gaps(obj, pobj, "", f"{name}.{n}")
    return out


def _entry_module(key: str) -> str:
    """The reference module a BY_DESIGN key belongs to: the longest
    module path that prefixes its dotted name."""
    dotted = key.split(" ", 1)[1].split("(")[0]
    return max((m for m in _ref_modules() if dotted.startswith(m + ".")),
               key=len)


@pytest.mark.parametrize("name", REF_MODULES)
def test_module_has_the_references_public_surface(name):
    want = sorted(k for k in BY_DESIGN if _entry_module(k) == name)
    assert sorted(gaps(name)) == want


def test_every_reference_module_is_walked_or_excluded():
    mods = set(_ref_modules())
    assert set(EXCLUDED_MODULES) <= mods
    assert len(REF_MODULES) + len(EXCLUDED_MODULES) == len(mods)
    for name in EXCLUDED_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module(_port_name(name))


@pytest.mark.parametrize("key", sorted(BY_DESIGN))
def test_by_design_entry_names_a_reason_and_a_counterpart(key):
    reason, counterpart = BY_DESIGN[key]
    assert reason.strip()
    assert counterpart.startswith("repro_torch.")
    parts = counterpart.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = _import(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        break
    else:
        pytest.fail(f"{counterpart} does not resolve")
