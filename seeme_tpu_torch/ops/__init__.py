"""The hand-written kernels' wrappers and tools.

`tensor_versions` keys the kernel-layout weight copies the models make
(`pointnet_fused.FusedPointnet`, the DDIM kernels' `KernelWeights`).
"""

import itertools


def tensor_versions(*modules) -> tuple:
    """Storage address and version counter of every tensor of the modules:
    it changes with `load_state_dict`, an in-place update or a move, so it
    keys the kernel-layout weight copies."""
    return tuple((t.data_ptr(), t._version)
                 for m in modules for t in itertools.chain(m.parameters(), m.buffers()))
