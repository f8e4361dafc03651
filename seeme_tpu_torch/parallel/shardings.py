"""Parameter placement on the (data, model) mesh
(`seeme_tpu/parallel/shardings.py`).

At model size 1 the JAX rule degenerates to replication, which is what the
port does: every rank holds every parameter whole and DDP keeps them equal
(`mesh.replicated`). The port has no tensor parallelism: a model size above
1 raises (no shipped config sets `MESH.MODEL_AXIS` above 1, and the fused
kernels read whole weights).
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from .mesh import check_model_axis

REPLICATED = "replicated"


def _model_size(mesh) -> int:
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index("model"))


def infer_param_shardings(module: nn.Module, mesh) -> Dict[str, str]:
    """{parameter name: "replicated"} at model size 1; raises above it."""
    check_model_axis(_model_size(mesh))
    return {name: REPLICATED for name, _ in module.named_parameters()}


def shard_params(module: nn.Module, mesh) -> nn.Module:
    """`module` as it is, once `infer_param_shardings` allows the mesh."""
    infer_param_shardings(module, mesh)
    return module
