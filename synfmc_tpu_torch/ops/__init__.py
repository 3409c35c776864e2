"""Attention, normalization and pixel ops; the CUDA kernels' wrappers live here.

Importing this package registers the kernels as ``torch.library`` ops
(``torch.ops.synfmc.*``, ops/_library.py): a process that runs a program
saved by ``torch.export`` (scripts/export_serving.py) imports it first.
"""

from synfmc_tpu_torch.ops import flash_attention as _flash  # noqa: F401  (registers the ops)
from synfmc_tpu_torch.ops import fused_groupnorm as _gn  # noqa: F401
from synfmc_tpu_torch.ops import temporal_attention as _temporal  # noqa: F401


def kernel_launches(backward: bool = False) -> dict[str, int]:
    """Launches so far in this process of each forward kernel of the serving
    path (K1 flash, K2 temporal, K3 group_norm), as their wrappers count them;
    with ``backward`` also of the train step's backward kernels (K5
    flash_bwd, K8 temporal_bwd)."""
    from synfmc_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm
    from synfmc_tpu_torch.ops.temporal_attention import temporal_attention, temporal_attention_bwd

    out = {"flash": flash_attention.launches, "temporal": temporal_attention.launches,
           "group_norm": fused_group_norm.launches}
    if backward:
        out.update(flash_bwd=flash_attention_bwd.launches,
                   temporal_bwd=temporal_attention_bwd.launches)
    return out
