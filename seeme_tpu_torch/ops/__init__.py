"""The hand-written kernels' wrappers and tools.

`tensor_versions` keys the kernel-layout weight copies the models make
(`pointnet_fused.FusedPointnet`, the DDIM kernels' `KernelWeights`), and
`module_state` gives those copies a module's whole tensors.
"""

import itertools
from typing import Dict

import torch


def tensor_versions(*modules) -> tuple:
    """Storage address and version counter of every tensor of the modules:
    it changes with `load_state_dict`, an in-place update or a move, so it
    keys the kernel-layout weight copies."""
    return tuple((t.data_ptr(), t._version)
                 for m in modules for t in itertools.chain(m.parameters(), m.buffers()))


def module_state(module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with each parametrized tensor under its own name
    as the module computes it, detached: a parameter that
    `parallel/shardings.py::shard_params` stores as a slice, gathered whole
    (a collective over its model-axis group)."""
    out = {}
    for key, value in module.state_dict().items():
        head, sep, tail = key.partition("parametrizations.")
        if not sep:
            out[key] = value
        elif tail.endswith(".original"):
            name = tail[: -len(".original")]
            owner = module.get_submodule(head[:-1]) if head else module
            out[head + name] = getattr(owner, name).detach()
    return out
