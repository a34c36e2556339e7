"""Tensor-parallel parameter layouts on a "model" mesh axis.

Port of ``mclstexp_tpu/parallel/tp.py``. JAX gives parameters
``PartitionSpec``s by path rules and lets GSPMD partition the matmuls:
column-parallel qkv and fc1 (the output features sharded), row-parallel out
and fc2 (the input features sharded), feature-sharded position tables, the
projection heads likewise, everything else replicated. The port keeps the
rules, keyed on its parameter names (the reference torch names that
``interop.params_from_jax`` writes) and translated to torch's (out, in)
weight layout, and places parameters as DTensors on the 2-D
``DeviceMesh``: ``Replicate()`` on "data", the rule's placement on "model"
(``torch.distributed.tensor``).

DTensor propagation partitions the products as GSPMD does. A module that
holds a sharded weight takes its inputs as ``Replicate`` DTensors and
hands on its output whole (``Replicate``, then the local tensor): a
column-parallel output is all-gathered, a row-parallel one all-reduced, so
the modules around them (the fused qkv's reshape into heads, which a
contiguous split of the output features would not keep head-aligned; the
flash kernels, which take whole contiguous tensors) see what one process
sees. A rank's batch rows differ along "data", where the DTensors claim
``Replicate``: no DTensor op reduces over "data"; the data-parallel step's
``average_gradients`` all-reduces each gradient's local shard over the
"data" group. Adam over DTensors steps one tensor at a time
(``train.state.torch_adam``). A checkpoint of a sharded model saves whole
tensors (``train.checkpoint``), so it loads in one process.

``shard_params`` replicates where JAX's does: on a mesh without a "model"
axis longer than 1 (the model stays as it is) and for a weight whose
sharded dim the axis does not divide (it stays a plain tensor).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from mclstexp_tpu_torch.train.state import TrainState, torch_adam

# (name regex, placement on "model") -- first match wins; default replicate.
# JAX's kernel specs on (in, out) kernels, here on (out, in) weights.
_TP_RULES: Tuple[Tuple[str, Placement], ...] = (
    (r".*\.attn\.fn\.to_qkv\.weight$", Shard(0)),  # P(None, "model"): column-parallel qkv
    (r".*\.attn\.fn\.to_out\.0\.weight$", Shard(1)),  # P("model", None): row-parallel out
    (r".*\.ff\.fn\.net\.0\.weight$", Shard(0)),  # ff/fc1, column-parallel
    (r".*\.ff\.fn\.net\.3\.weight$", Shard(1)),  # ff/fc2, row-parallel
    (r"(.*\.)?(x|y)_embed\.weight$", Shard(1)),  # feature-sharded position tables
    (r".*projection\.projection\.weight$", Shard(0)),
    (r".*projection\.fc\.weight$", Shard(1)),
)


def param_placement(name: str) -> Placement:
    """The placement on "model" of the parameter ``name`` by the rules."""
    for pattern, placement in _TP_RULES:
        if re.match(pattern, name):
            return placement
    return Replicate()


def tp_param_placements(model: nn.Module) -> Dict[str, Placement]:
    """{parameter name: its placement on "model"} for every parameter of
    ``model`` (JAX's ``tp_param_specs``)."""
    return {name: param_placement(name) for name, _ in model.named_parameters()}


def _whole_inputs(module, args):
    mesh = module.tp_mesh
    return tuple(DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
                 if isinstance(a, torch.Tensor) else a for a in args)


def _whole_output(module, args, out):
    mesh = module.tp_mesh
    return out.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` by the rules, in place:
    each weight the rules shard (and whose sharded dim the "model" axis
    divides) becomes a DTensor ``[Replicate()`` on "data", the rule's
    placement on "model"``]``, with the other parameters of its module as
    replicated DTensors; the module then takes and gives whole tensors.
    Every other parameter stays a plain tensor, replicated. Returns
    ``model``."""
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return model
    n_model = mesh.size(names.index("model"))
    sharded = {}
    for name, p in model.named_parameters():
        placement = param_placement(name)
        if isinstance(placement, Shard) and p.ndim > placement.dim and \
                p.shape[placement.dim] % n_model == 0:
            module_name, _, leaf = name.rpartition(".")
            sharded.setdefault(module_name, {})[leaf] = placement
    for module_name, placements in sharded.items():
        module = model.get_submodule(module_name)
        for leaf, p in list(module.named_parameters(recurse=False)):
            spec = [Replicate() if axis != "model" else placements.get(leaf, Replicate())
                    for axis in names]
            module.register_parameter(leaf, nn.Parameter(distribute_tensor(p.detach(), mesh,
                                                                           spec)))
        module.tp_mesh = mesh
        module.register_forward_pre_hook(_whole_inputs)
        module.register_forward_hook(_whole_output)
    return model


def shard_train_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """A fresh train state (no optimizer step taken yet) with its model's
    parameters placed by ``shard_params`` and a new Adam of the same
    hyper-parameters over them. JAX's test does the same to its state."""
    if state.optimizer.state:
        raise ValueError("shard_train_state takes a state whose optimizer has taken no step")
    defaults = state.optimizer.defaults
    model = shard_params(state.model, mesh)
    return TrainState(model, torch_adam(model.parameters(), defaults["lr"],
                                        defaults["weight_decay"]), state.step)
