"""The port's routing gates on the CPU: a shape goes to a kernel only if that
kernel can run it on the card, decided from shape and dtype alone, so the
CPU and the card route the same shapes the same way.  Shapes a gate declines
take the plain path, as the JAX package falls to XLA."""

import numpy as np
import pytest
import torch

from synfmc_tpu_torch.ops import norms
from synfmc_tpu_torch.ops.attention import route
from synfmc_tpu_torch.ops.fused_groupnorm import group_norm_plain
from synfmc_tpu_torch.ops.temporal_attention import (
    SMEM_OPTIN,
    temporal_attention_bwd,
    temporal_supported,
    unit_bytes,
)

# (dtype, N, F, H, D) whose K8 unit (and for bf16 D = 512 only K8's) passes
# the opt-in: fp32 K8 at F = 48, D = 400 and at F = 64, D = 256; bf16 K8 at
# F = 64, D = 512.
DECLINED = [(torch.float32, 8, 48, 1, 400), (torch.float32, 8, 64, 1, 256),
            (torch.bfloat16, 8, 64, 1, 512)]
# Every temporal key of the flagship's serving and train paths (N, F, H, D):
# the motion modules of the CFG pair at the four levels and the mid block,
# the pose encoder, and the train step's batch-1 motion modules.
FLAGSHIP = [(3072, 16, 8, 40), (768, 16, 8, 80), (192, 16, 8, 160), (48, 16, 8, 160),
            (32, 24, 8, 160), (1536, 16, 8, 40), (384, 16, 8, 80), (96, 16, 8, 160),
            (24, 16, 8, 160), (16, 24, 8, 160)]


def _meta(*shape, dtype):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,n,f,h,d", DECLINED)
def test_temporal_gate_declines_units_above_the_optin(dtype, n, f, h, d):
    assert max(unit_bytes(f, d, dtype)) > SMEM_OPTIN
    assert not temporal_supported(_meta(n, f, h * d, dtype=dtype), h)
    q = _meta(n, f, h, d, dtype=dtype)
    assert route(q, q) == "plain"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_temporal_gate_takes_every_flagship_key(dtype):
    for n, f, h, d in FLAGSHIP:
        assert temporal_supported(_meta(n, f, h * d, dtype=dtype), h), (n, f, h, d)
        q = _meta(n, f, h, d, dtype=dtype)
        assert route(q, q) == "temporal"


def test_unit_bytes_follow_the_launchers():
    """The formulas at shapes worked by hand from the launchers: fp32 K2 fits
    one head at F = 48, D = 400 and K8 does not."""
    assert unit_bytes(48, 400, torch.float32) == (3 * 48 * 401 * 4, 4 * 48 * 401 * 4
                                                  + 2 * 48 * 49 * 4)
    assert unit_bytes(16, 40, torch.bfloat16) == (3 * 16 * 40 * 2, (4 * 16 * 40 + 2 * 16 * 24) * 2)
    assert unit_bytes(64, 512, torch.bfloat16) == (3 * 64 * 520 * 2,
                                                   (4 * 64 * 520 + 2 * 64 * 72) * 2)
    assert unit_bytes(48, 400, torch.float32)[0] <= SMEM_OPTIN


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_temporal_wrappers_raise_on_a_unit_they_cannot_hold():
    """On a CUDA tensor the wrapper itself raises before any launch: the
    route is chosen before the kernel, not after a failure."""
    before = temporal_attention_bwd.launches
    x = torch.zeros((8, 48, 400)).as_subclass(_ReportsCuda)
    with pytest.raises(ValueError, match="shared memory"):
        temporal_attention_bwd(x, x, x, x, 0.05, 1)
    x = torch.zeros((8, 64, 512), dtype=torch.bfloat16).as_subclass(_ReportsCuda)
    with pytest.raises(ValueError, match="shared memory"):
        temporal_attention_bwd(x, x, x, x, 0.05, 1)
    assert temporal_attention_bwd.launches == before


@pytest.mark.parametrize("c,offset", [(8192, 0), (320, 0), (320, 1)])
def test_group_norm_routes_by_shape(monkeypatch, c, offset):
    """norms.group_norm sends a slab above K3's channel limit to the plain
    version and every other one to the fused wrapper, an x off 16 bytes on
    an aligned copy; the result equals group_norm_plain."""
    rng = np.random.default_rng(0)
    buf = torch.from_numpy(rng.normal(size=2 * 4 * c + offset).astype(np.float32))
    x = buf[offset:].view(2, 4, c)
    w = torch.from_numpy(1 + 0.1 * rng.normal(size=c).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.normal(size=c).astype(np.float32))
    seen = []

    def fused(x, *a, **kw):
        seen.append(x.data_ptr() % 16)
        return group_norm_plain(x, *a, **kw)

    monkeypatch.setattr(norms, "fused_group_norm", fused)
    got = norms.group_norm(x, w, b, 32, 1e-6, "silu")
    assert seen == ([] if c > 6144 else [0])
    np.testing.assert_allclose(got.numpy(), group_norm_plain(x, w, b, 32, 1e-6, "silu").numpy(),
                               rtol=1e-6, atol=1e-6)
