"""Attention, normalization and pixel ops; the CUDA kernels' wrappers live here."""


def kernel_launches() -> dict[str, int]:
    """Launches so far in this process of each forward kernel of the serving
    path (K1 flash, K2 temporal, K3 group_norm), as their wrappers count them."""
    from synfmc_tpu_torch.ops.flash_attention import flash_attention
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm
    from synfmc_tpu_torch.ops.temporal_attention import temporal_attention

    return {"flash": flash_attention.launches, "temporal": temporal_attention.launches,
            "group_norm": fused_group_norm.launches}
