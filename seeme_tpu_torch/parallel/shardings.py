"""Parameter placement on the (data, model) mesh
(`seeme_tpu/parallel/shardings.py`).

The JAX rule (`shardings.py:26-33`): a parameter of two dims or more whose
last axis is at least 512 wide and divisible by the model axis' size m is
sharded over ``model`` on that axis; every other one is replicated. The
port applies the rule to each parameter's JAX layout, as `convert.py` maps
the layouts:

- a Linear's or an RNN's weight is (out, in) here and (in, out) there, a
  convolution's (O, I, ...) here and (..., I, O) there: the JAX last axis
  is torch dim 0;
- the attention's `in_proj_weight` stacks the three JAX kernels q, k and v
  (each (D, D), last axis D) on dim 0: sharded when each of them is;
- every other parameter keeps the JAX layout (the VAE's motion token, a
  position table, an embedding table, the GCN's weights): its last dim.

`shard_params` stores each such parameter as the rank's 1/m slice on its
model coordinate, under a `torch.nn.utils.parametrize` parametrization
whose forward gathers the whole tensor from the rank's model-axis group:
every module, and every fused kernel's operand copy
(`ops/__init__.py::module_state`), sees plain whole tensors. The gather is
an all-reduce of a zero-filled whole buffer that holds the rank's slice,
exact since each element has one non-zero addend; gloo all-reduces CUDA
tensors but does not all-gather them, so one code path serves every
backend. Its backward keeps the rank's slice of the whole gradient: the
model-axis ranks compute the same rows, so each already holds the whole
gradient (a reduce-scatter sum would multiply it by m). Under DDP the
gradients are then averaged over the rank's data-axis group
(`mesh.replicated(..., group=mesh.get_group("data"))`). AdamW over the module's
parameters keeps its moments for the slices: 1/m of each sharded tensor.
Every access of a sharded tensor is a collective over the model-axis
group, so its ranks must run the same forward, as they do when they train
the same rows in lockstep. No CLI calls `shard_params`, as in the JAX
package (`train.py` replicates the parameters on any mesh).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from ..nn.transformer import MultiHeadAttention

# kernels at least this wide on their JAX last axis are sharded (`shardings.py:21`)
MIN_SHARD_DIM = 512
_OUT_FIRST = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.RNNBase)


def model_size(mesh) -> int:
    """The model axis' size of a `DeviceMesh` (an int is that size; no mesh is 1)."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index("model")) if "model" in names else 1


def _jax_last_axis(module: nn.Module, name: str, p: torch.Tensor) -> Tuple[int, List[int]]:
    """(the torch dim that holds the JAX layout's last axis, the widths of
    the JAX kernels stacked on it)."""
    if isinstance(module, MultiHeadAttention) and name == "in_proj_weight":
        return 0, [p.shape[0] // 3] * 3
    if isinstance(module, _OUT_FIRST):
        return 0, [p.shape[0]]
    return p.dim() - 1, [p.shape[-1]]


def infer_param_shardings(module: nn.Module, mesh) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dim sharded over ``model``, or None for a
    replicated one}, by the JAX rule on the JAX layout; every entry None at
    a model axis of 1."""
    m = model_size(mesh)
    out: Dict[str, Optional[int]] = {}
    for prefix, owner in module.named_modules():
        for name, p in owner.named_parameters(recurse=False):
            dim = None
            if m > 1 and p.dim() >= 2:
                d, widths = _jax_last_axis(owner, name, p)
                if all(w >= MIN_SHARD_DIM and w % m == 0 for w in widths):
                    dim = d
            out[f"{prefix}.{name}" if prefix else name] = dim
    return out


class _Gather(torch.autograd.Function):
    """The whole tensor from each model-axis rank's slice on `dim`; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, piece, dim, coord, size, group):
        n = piece.shape[dim]
        shape = list(piece.shape)
        shape[dim] = n * size
        whole = piece.new_zeros(shape)
        whole.narrow(dim, coord * n, n).copy_(piece)
        dist.all_reduce(whole, group=group)
        ctx.dim, ctx.start, ctx.n = dim, coord * n, n
        return whole

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None, None, None


class ModelAxisShard(nn.Module):
    """The parametrization of a sharded parameter: it stores the rank's
    slice (`right_inverse`) and gives the whole tensor (`forward`)."""

    def __init__(self, dim: int, coord: int, size: int, group):
        super().__init__()
        self.dim, self.coord, self.size, self.group = dim, coord, size, group

    def forward(self, piece: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(piece, self.dim, self.coord, self.size, self.group)

    def right_inverse(self, whole: torch.Tensor) -> torch.Tensor:
        n = whole.shape[self.dim] // self.size
        return whole.narrow(self.dim, self.coord * n, n).clone()


def shard_params(module: nn.Module, mesh) -> nn.Module:
    """`module` with each parameter `infer_param_shardings` shards stored as
    the rank's slice on its model coordinate (`ModelAxisShard`); as it is
    at a model axis of 1."""
    m = model_size(mesh)
    if m == 1:
        return module
    group, coord = mesh.get_group("model"), mesh.get_local_rank("model")
    for name, dim in infer_param_shardings(module, mesh).items():
        if dim is not None:
            prefix, _, leaf = name.rpartition(".")
            parametrize.register_parametrization(
                module.get_submodule(prefix), leaf, ModelAxisShard(dim, coord, m, group),
                unsafe=True)
    return module
