"""Logical-axis → mesh-axis sharding rules and activation constraints on a
torch ``DeviceMesh``.

Mirrors :mod:`repro.distributed.sharding`.  Every parameter and cache
entry is declared with *logical* axes (:class:`repro_torch.models.layers.
ParamDef`); a :class:`ShardingRules` table maps each logical axis to mesh
axes.  The production mesh axes are

* ``pod``   — inter-pod data parallelism (multi-pod mesh only),
* ``data``  — intra-pod data parallel / FSDP axis,
* ``model`` — tensor / expert / sequence parallel axis.

The defaults implement FSDP(embed) × TP(heads/mlp/vocab) × EP(experts);
architectures whose dimensions do not divide the axis (hymba's 25 heads,
qwen2-moe's 60 experts) override single rules.

A *spec* here is what the reference's ``PartitionSpec`` holds: a tuple
with one entry per tensor dimension (``None``, a mesh-axis name, or a
tuple of names, major first), trailing ``None`` entries dropped.
:func:`spec_to_placements` turns one into DTensor placements on a named
``DeviceMesh``: mesh dimension ``a`` gets ``Shard(i)`` when ``a`` appears
in entry ``i`` and has more than one rank, else ``Replicate()``.

The rules take a ``DeviceMesh`` with ``mesh_dim_names``, a mapping of
axis name to size, or any object whose ``shape`` is such a mapping (the
reference's tests' stand-in), so that they can be held against the
reference without a process group.

``shard_map_compat`` has no counterpart: it papers over ``jax.shard_map``'s
API churn between jax releases.  The port's manual-axis region is a
process subgroup (``mesh["pod"].get_group()``, see
:func:`repro_torch.launch.steps.build_compressed_dp_cell`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

__all__ = ["ShardingRules", "DEFAULT_RULES", "rules_for", "logical_to_spec",
           "spec_tree", "batch_spec", "named_sharding_tree",
           "spec_to_placements", "mesh_axes", "activation_sharding",
           "constrain", "active", "is_dtensor", "from_local_like"]

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a mapping, or an object whose
    ``shape`` is a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, Axis], ...]

    def as_dict(self) -> Dict[str, Axis]:
        return dict(self.rules)

    def override(self, **kw: Axis) -> "ShardingRules":
        d = self.as_dict()
        d.update(kw)
        return ShardingRules(tuple(d.items()))


# fsdp axes: both pod and data shard the embed dim of weights (ZeRO-3
# style); on the single-pod mesh "pod" is absent and is dropped.
_FSDP = ("pod", "data")

DEFAULT_RULES = ShardingRules((
    ("batch", _FSDP),          # activations' batch dim
    ("seq", None),
    ("embed", _FSDP),          # weights' d_model dim → FSDP
    ("embed2", None),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv", None),              # few KV heads — replicate (GQA); per-arch
    ("mlp", "model"),
    ("expert_mlp", "model"),
    ("experts", "model"),      # EP
    ("ssm_in", "model"),
    ("layers", None),
    ("layers_inner", None),
    ("kv_seq", None),          # decode-cache sequence dim (long_500k: model)
    # --- activation logical axes (constrain targets) ----------------------
    ("act_batch", _FSDP),
    ("act_seq", None),
    ("act_embed", None),
    ("act_heads", "model"),
    ("act_kv", None),          # per-arch: "model" when KVH divides
    ("act_kv_group", None),    # GQA carry [B,KVH,G,...]: shard KVH…
    ("act_q_group", "model"),  # …or the per-KV query group G
    ("act_ff", "model"),
    ("act_exp", "model"),
    ("act_ssm_heads", "model"),
    ("act_vocab", "model"),
))


def rules_for(cfg, mesh, *, long_context: bool = False) -> ShardingRules:
    """Per-arch rule adjustments for divisibility and shape kind (the
    reference's, rule for rule)."""
    shape = mesh_axes(mesh)
    r = DEFAULT_RULES
    msize = shape.get("model", 1)
    dsize = shape.get("data", 1) * shape.get("pod", 1)
    if cfg.n_heads % msize:
        r = r.override(heads=None, act_heads=None)       # hymba: 25 heads
    if cfg.n_kv_heads % msize == 0:
        # enough KV heads to shard them
        r = r.override(kv="model", act_kv="model", act_kv_group="model",
                       act_q_group=None)
    elif cfg.n_heads % msize == 0 and (cfg.n_heads // cfg.n_kv_heads) % msize:
        # neither KVH nor G divides, but H does (qwen1.5-110b 64H kv8): KV
        # is broadcast to H heads (cfg.attn_broadcast_kv) and the merged
        # head dim shards
        r = r.override(act_kv="model", act_kv_group="model",
                       act_q_group=None)
    if cfg.n_experts and cfg.n_experts % msize:
        r = r.override(experts=None, expert_mlp="model")  # qwen2-moe: 60
    if cfg.d_model % dsize:
        r = r.override(embed=None, batch="data", act_batch="data")
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * cfg.d_model
        if d_in % msize:
            r = r.override(ssm_in=None)
        if (d_in // cfg.ssm_headdim) % msize:
            r = r.override(act_ssm_heads=None)
    if long_context:
        # batch 1: the 500k KV cache must shard on `model`: KV heads if
        # they divide, else the cache's sequence dim
        if cfg.n_kv_heads % msize == 0:
            r = r.override(kv="model")
        else:
            r = r.override(kv_seq="model")
    return r


def logical_to_spec(axes: Tuple[Optional[str], ...], rules: ShardingRules,
                    mesh, shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Map one leaf's logical axes to a spec, dropping mesh axes that are
    absent, already used by an earlier dimension, or that don't divide the
    dimension."""
    sizes = mesh_axes(mesh)
    table = rules.as_dict()
    used = set()
    out = []
    for i, ax in enumerate(axes):
        phys = table.get(ax) if ax else None
        if phys is None:
            out.append(None)
            continue
        cand = (phys,) if isinstance(phys, str) else tuple(phys)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        if shape is not None and cand:
            n = 1
            kept = []
            for a in cand:
                if shape[i] % (n * sizes[a]) == 0:
                    kept.append(a)
                    n *= sizes[a]
            cand = tuple(kept)
        if not cand:
            out.append(None)
        else:
            used.update(cand)
            out.append(cand[0] if len(cand) == 1 else cand)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_tree(defs: Mapping, rules: ShardingRules, mesh) -> Dict[str, Spec]:
    """{name: ParamDef} → {name: spec} (divisibility-checked)."""
    return {k: logical_to_spec(d.axes, rules, mesh, d.shape)
            for k, d in defs.items()}


def spec_to_placements(spec: Spec, mesh) -> list:
    """A spec → one DTensor placement per dimension of the named
    ``mesh`` (a mesh dimension of size 1 replicates: a shard of one is the
    whole, and DTensor's view rules treat it as sharded)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for i, prt in enumerate(spec):
        for a in ((prt,) if isinstance(prt, str) else (prt or ())):
            where[a] = i
    return [Shard(where[n]) if n in where and mesh.size(j) > 1
            else Replicate() for j, n in enumerate(mesh.mesh_dim_names)]


def named_sharding_tree(defs: Mapping, rules: ShardingRules, mesh
                        ) -> Dict[str, list]:
    """{name: ParamDef} → {name: DTensor placements on ``mesh``}."""
    return {k: spec_to_placements(s, mesh)
            for k, s in spec_tree(defs, rules, mesh).items()}


def batch_spec(mesh, batch: int) -> Spec:
    """Spec of a [B, ...] input: batch over (pod, data) where divisible."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    kept = []
    for a in axes:
        if batch % (n * sizes[a]) == 0:
            kept.append(a)
            n *= sizes[a]
    if not kept:
        return ()
    return (tuple(kept) if len(kept) > 1 else kept[0],)


# ---------------------------------------------------------------------------
# activation sharding constraints
# ---------------------------------------------------------------------------
# Model code calls ``constrain(x, axes…)`` at the reference's points; inside
# an ``activation_sharding(mesh, rules)`` context a DTensor ``x`` is
# redistributed to the constrained layout (a plain tensor is left as it is:
# it is replicated by construction); outside the context the call returns
# ``x`` untouched, so single-device runs are unchanged to the bit.

_ACT_CTX: list = []


@contextlib.contextmanager
def activation_sharding(mesh, rules: ShardingRules,
                        manual_axes: frozenset = frozenset()):
    """``manual_axes``: mesh axes that the caller runs by hand (the pod
    axis of the compressed-DP step); constraints leave them out.  Inside
    the context, plain tensors meeting DTensors in one op count as
    replicated (``implicit_replication``): rope tables, masks and
    positions are made on every rank alike."""
    from torch.distributed.tensor.experimental import implicit_replication
    _ACT_CTX.append((mesh, rules, frozenset(manual_axes)))
    try:
        with implicit_replication():
            yield
    finally:
        _ACT_CTX.pop()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def from_local_like(t: torch.Tensor, like):
    """Each rank's result ``t`` of a local computation as a DTensor of
    ``like``'s global shape and placements (``t`` made contiguous)."""
    from torch.distributed.tensor import DTensor
    st, acc = [], 1
    for n in reversed(tuple(like.shape)):
        st.append(acc)
        acc *= n
    return DTensor.from_local(t.contiguous(), like.device_mesh,
                              like.placements, run_check=False,
                              shape=like.shape, stride=tuple(reversed(st)))


def active():
    """(mesh, rules, manual_axes) of the innermost context, or None."""
    return _ACT_CTX[-1] if _ACT_CTX else None


def constrain(x, *axes, shape: Optional[Tuple[int, ...]] = None):
    """Redistribute a DTensor ``x`` to the layout its logical axes give
    (no-op outside the context, and on a plain tensor).  ``shape``, if
    given, is the one the divisibility checks read in place of
    ``x.shape``."""
    if not _ACT_CTX:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules, manual = _ACT_CTX[-1]
    spec = logical_to_spec(tuple(axes), rules, mesh,
                           tuple(shape or x.shape))
    if manual:
        spec = tuple(_strip(prt, manual) for prt in spec)
    want = tuple(spec_to_placements(spec, x.device_mesh))
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, want)
    if want == tuple(x.placements):
        return x
    return _redistribute(x, want)


def _redistribute(x, want):
    """``x`` laid out as ``want``, its local shard contiguous: gathering a
    dimension that divides unevenly (1,500 frames over 16 ranks) pads and
    narrows, and a later ``view`` of that shard would fail."""
    y = x.redistribute(x.device_mesh, want)
    if y.to_local().is_contiguous():
        return y
    return from_local_like(y.to_local(), y)


class _Constrain(torch.autograd.Function):
    """The layout constraint both ways, as ``with_sharding_constraint``'s
    transpose constrains the cotangent: the gradient is redistributed to
    the same placements (else DTensor picks the backward's layouts by
    communication cost alone, and may all-gather a weight where a
    partial gradient should have been reduced)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return _redistribute(x, want)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.want), None


def _strip(prt: Axis, manual: frozenset) -> Axis:
    if prt is None:
        return None
    if isinstance(prt, tuple):
        kept = tuple(a for a in prt if a not in manual)
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return None if prt in manual else prt
