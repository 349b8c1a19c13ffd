"""Cell builder: for an (architecture × shape × mesh) cell, the step
function over DTensor parameters, and its arguments.

Mirrors :mod:`repro.launch.steps`.  The reference returns a function to
``jax.jit`` with abstract inputs and in/out shardings; the port's step
runs eagerly on DTensors.  :func:`build_cell` places the model's
parameters on the mesh by :func:`~repro_torch.distributed.sharding.
spec_tree` (DTensor placements), and :meth:`Cell.make_args` allocates
the step's other arguments on the mesh's device (fake tensors under
``FakeTensorMode``, as the dry run builds them): the AdamW state laid out
as the parameters, batch inputs by :func:`~repro_torch.distributed.
sharding.batch_spec`, the decode cache by its ParamDefs.  A step runs
its model call inside :func:`~repro_torch.distributed.sharding.
activation_sharding`, where the model's ``constrain`` points apply.

* train:   ``fn(params, opt_state, batch) → (params, opt_state, loss)``;
  the port's AdamW updates the parameters in place, at the cosine
  schedule's rate (peak 3e-4, 2,000 warm-up steps, 100,000 in all, as the
  reference's);
* prefill: ``fn(params, batch) → (cache, last-token logits, next
  position)``, the model's prefill's triple (the reference's jitted step
  leaves the position to its caller's static shapes);
* decode:  ``fn(params, cache, batch) → (logits, cache)``, one token at
  ``batch["pos"]`` against a cache of ``seq_len`` entries.

``params`` is the model's own parameter dict (:attr:`Cell.params`): the
step runs the model that holds them.  :class:`CellEngine` serves waves of
requests through a prefill and a decode cell with ``ServeEngine``'s own
loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..distributed.sharding import (activation_sharding, batch_spec,
                                    logical_to_spec, named_sharding_tree,
                                    rules_for, spec_to_placements)
from ..models import build_model, input_specs
from ..models.config import ModelConfig, ShapeConfig
from ..models.lm import Block
from ..optim import adamw_init, adamw_update, cosine_schedule
from ..serving import ServeEngine

__all__ = ["Cell", "CellEngine", "build_cell", "build_compressed_dp_cell",
           "place", "place_params", "place_batch"]


@dataclasses.dataclass
class Cell:
    name: str
    kind: str                       # train | prefill | decode
    fn: Callable
    model: nn.Module
    mesh: Any
    rules: Any
    shape: ShapeConfig
    #: {parameter name: DTensor placements}
    placements: Dict[str, list]
    #: the batch inputs' stand-ins (``input_specs``: meta tensors)
    inputs: Dict[str, torch.Tensor]
    meta: Dict[str, Any]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def make_args(self, batch: Optional[Dict[str, Any]] = None) -> tuple:
        """The step's arguments on the mesh: zeros of the stand-ins'
        shapes unless ``batch`` is given (plain tensors, placed here);
        a decode step's ``pos`` is ``seq_len - 1`` (a full cache)."""
        mesh = self.mesh
        dev = mesh.device_type
        if batch is None:
            batch = {k: (self.shape.seq_len - 1 if k == "pos" else
                         torch.zeros(v.shape, dtype=v.dtype, device=dev))
                     for k, v in self.inputs.items()}
        batch = place_batch(batch, mesh)
        if self.kind == "train":
            return self.params, adamw_init(self.params), batch
        if self.kind == "prefill":
            return self.params, batch
        B, S = self.shape.global_batch, self.shape.seq_len
        dtype = next(iter(self.params.values())).dtype
        cache = self.model.init_cache(B, S, dtype)
        cdefs = self.model.cache_defs(B, S)
        cache = [{k: place(t, mesh, spec_to_placements(logical_to_spec(
            cdefs[i][k].axes, self.rules, mesh, tuple(t.shape)), mesh))
            for k, t in layer.items()} for i, layer in enumerate(cache)]
        return self.params, cache, batch


def place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A plain tensor, the same on every rank, as a DTensor of
    ``placements``: each rank keeps its own shard (no communication); on a
    one-rank mesh the tensor itself, without a copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, placements, run_check=False)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def place_params(model: nn.Module, mesh, rules) -> Dict[str, list]:
    """Replace every parameter of ``model`` by a DTensor placed by the
    rules (``requires_grad`` kept); returns the placements."""
    from torch.distributed.tensor import DTensor
    pls = named_sharding_tree(model.param_defs(), rules, mesh)
    for name, prm in list(model.named_parameters()):
        if isinstance(prm.data, DTensor):
            continue
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = model.get_submodule(owner)
        mod._parameters[leaf] = nn.Parameter(
            place(prm.detach(), mesh, pls[name]),
            requires_grad=prm.requires_grad)
    return pls


def place_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Batch inputs as DTensors: [B, ...] over (pod, data) where B
    divides, a 0-d tensor replicated, a Python number left as it is."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        spec = batch_spec(mesh, v.shape[0]) if v.dim() else ()
        out[k] = place(v, mesh, spec_to_placements(spec, mesh))
    return out


def _adjust(cfg: ModelConfig, shape: ShapeConfig, mesh) -> ModelConfig:
    """The reference's per-cell config changes: KV broadcast to H heads
    where only H divides the model axis; grouped MoE dispatch aligned
    with the data shards outside decode."""
    from ..distributed.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    msize = sizes.get("model", 1)
    if (cfg.n_heads % msize == 0 and cfg.n_kv_heads % msize
            and (cfg.n_heads // cfg.n_kv_heads) % msize):
        cfg = dataclasses.replace(cfg, attn_broadcast_kv=True)
    if cfg.n_experts and shape.kind != "decode":
        dsize = sizes.get("data", 1) * sizes.get("pod", 1)
        T = shape.global_batch * shape.seq_len
        if T % dsize == 0:
            cfg = dataclasses.replace(cfg, moe_groups=dsize)
    return cfg


def _with_cfg(model: nn.Module, cfg: ModelConfig) -> nn.Module:
    """Give ``model`` and its layers the adjusted config (the flags
    :func:`_adjust` sets change no parameter)."""
    model.cfg = cfg
    for m in model.modules():
        if isinstance(m, Block):
            m.cfg = cfg
    return model


def _extras(batch: Dict[str, Any], *skip: str) -> Dict[str, Any]:
    return {k: v for k, v in batch.items() if k not in skip}


def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """f32 gradients of every parameter, zeros for one the loss does not
    read (whisper's cross-attention ``x_bk`` / ``x_bv``)."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                             materialize_grads=True)
    return {k: g.float() for k, g in zip(params, gs)}


def _default_lr(step):
    return cosine_schedule(step, 3e-4, 2000, 100_000)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               dtype=torch.bfloat16, rules=None,
               lr_schedule: Optional[Callable] = None,
               model: Optional[nn.Module] = None) -> Cell:
    """The cell's step over ``model`` (built uninitialised on the mesh's
    device in ``dtype`` when not given) with its parameters placed on
    ``mesh``."""
    cfg = _adjust(cfg, shape, mesh)
    if model is None:
        model = build_model(cfg, dtype=dtype, device=mesh.device_type)
    _with_cfg(model, cfg)
    rules = rules or rules_for(cfg, mesh,
                               long_context=shape.name == "long_500k")
    if shape.kind == "train":
        model.requires_grad_(True)
    pls = place_params(model, mesh, rules)
    meta = {"arch": cfg.name, "shape": shape.name, "rules": rules.as_dict(),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}
    lr_fn = lr_schedule or _default_lr
    S = shape.seq_len

    def train_step(params, opt_state, batch):
        with activation_sharding(mesh, rules):
            loss = model.loss(batch["tokens"], batch["labels"],
                              **_extras(batch, "tokens", "labels"))
            grads = _grads(loss, params)
            opt_state = adamw_update(params, grads, opt_state,
                                     lr_fn(opt_state.step))
        return params, opt_state, loss

    def prefill(params, batch):
        with activation_sharding(mesh, rules), torch.no_grad():
            return model.prefill(batch["tokens"], S,
                                 **_extras(batch, "tokens"))

    def serve_step(params, cache, batch):
        with activation_sharding(mesh, rules), torch.no_grad():
            logits, cache = model.decode_step(cache, batch["token"],
                                              int(batch["pos"]), S)
        return logits, cache

    fn = {"train": train_step, "prefill": prefill,
          "decode": serve_step}[shape.kind]
    return Cell(name=f"{cfg.name}:{shape.name}", kind=shape.kind, fn=fn,
                model=model, mesh=mesh, rules=rules, shape=shape,
                placements=pls, inputs=input_specs(cfg, shape, dtype),
                meta=meta)


def build_compressed_dp_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                             dtype=torch.bfloat16,
                             lr_schedule: Optional[Callable] = None,
                             model: Optional[nn.Module] = None) -> Cell:
    """Cross-pod data parallelism with an **int8 gradient wire format**.

    Layout: FSDP × TP *within* a pod (the (data, model) submesh);
    parameters and optimizer state replicated *across* pods; each pod
    takes its share of the batch, and the cross-pod gradient mean runs
    over the int8 payload (:func:`~repro_torch.distributed.compression.
    pairwise_compressed_mean`) on the pod axis's process group
    (``mesh["pod"].get_group()``), the reference's manual ``shard_map``
    axis.  Vocab stays replicated, as the reference's rules have it.

    STATUS: experimental, as in the reference.  The tests show one step
    on gloo ranks and its loss; nothing is claimed of its speed.
    """
    from ..distributed.compression import pairwise_compressed_mean
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names or shape.kind != "train":
        raise ValueError("build_compressed_dp_cell: a train shape on a "
                         "mesh with a pod axis")
    n_pods = mesh["pod"].size()
    pod_group = mesh["pod"].get_group()
    inner = mesh[tuple(n for n in names if n != "pod")]
    cfg = _adjust(cfg, shape, mesh)
    if model is None:
        model = build_model(cfg, dtype=dtype, device=mesh.device_type)
    _with_cfg(model, cfg)
    rules = rules_for(cfg, mesh).override(embed=("data",),
                                          batch=("pod", "data"),
                                          vocab=None, act_vocab=None)
    model.requires_grad_(True)
    pls = place_params(model, inner, rules)
    lr_fn = lr_schedule or _default_lr

    def train_step(params, opt_state, batch):
        from torch.distributed.tensor import DTensor
        with activation_sharding(inner, rules,
                                 manual_axes=frozenset({"pod"})):
            loss = model.loss(batch["tokens"], batch["labels"],
                              **_extras(batch, "tokens", "labels"))
            red = {}
            for (k, p), g in zip(params.items(), _grads(loss, params).values()):
                g = g.redistribute(inner, p.placements).to_local()
                m = pairwise_compressed_mean(g, pod_group, n_pods)[0]
                red[k] = DTensor.from_local(m, inner, p.placements,
                                            run_check=False)
            opt_state = adamw_update(params, red, opt_state,
                                     lr_fn(opt_state.step))
            loss = loss.full_tensor().detach()
        torch.distributed.all_reduce(loss, group=pod_group)
        return params, opt_state, loss / n_pods

    pod_shape = dataclasses.replace(
        shape, global_batch=shape.global_batch // n_pods)
    return Cell(name=f"{cfg.name}:{shape.name}:int8dp", kind="train",
                fn=train_step, model=model, mesh=inner, rules=rules,
                shape=pod_shape, placements=pls,
                inputs=input_specs(cfg, pod_shape, dtype),
                meta={"arch": cfg.name, "shape": shape.name,
                      "rules": rules.as_dict(),
                      "params": cfg.param_count(),
                      "active_params": cfg.active_param_count(),
                      "grad_wire": "int8+error-feedback"})


class CellEngine(ServeEngine):
    """``ServeEngine``'s loop (waves left-padded to one prompt length,
    greedy or sampled tokens, its spans) over a prefill and a decode cell
    of one model: each step's inputs placed on the cells' mesh (the same
    on every rank), its logits gathered whole before sampling, the caches
    DTensors in between.  The cache holds the prefill cell's ``seq_len``
    entries."""

    def __init__(self, prefill: Cell, decode: Cell, batch: int, **kw):
        if prefill.model is not decode.model or (prefill.kind, decode.kind) \
                != ("prefill", "decode"):
            raise ValueError("CellEngine: a prefill and a decode cell of "
                             "one model")
        super().__init__(prefill.model.cfg, batch, prefill.shape.seq_len,
                         device=prefill.mesh.device_type,
                         model=prefill.model, **kw)
        self.cells = (prefill, decode)

    def _prefill(self, tokens: torch.Tensor, **extras):
        cell = self.cells[0]
        with self.tracer.span("prefill"):
            out = cell.fn(*cell.make_args(dict(tokens=tokens, **extras)))
            self._sync()
        return out

    def _decode(self, cache, token: torch.Tensor, pos: int):
        cell = self.cells[1]
        with self.tracer.span("decode_step"):
            out = cell.fn(cell.params, cache, place_batch(
                {"token": token, "pos": pos}, cell.mesh))
            self._sync()
        return out

    def _sample(self, logits) -> np.ndarray:
        return super()._sample(logits.full_tensor())
