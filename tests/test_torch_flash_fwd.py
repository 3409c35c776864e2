"""K1, the flash attention forward, on the CPU: the Python mirror of the
launcher's instance choice (ops/flash_attention.py:fwd_instance) against
hand-worked values and against the instance tables of csrc/flash_fwd.cu.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py), which also checks each instance's shared memory against the
card's opt-in.
"""

import re
from pathlib import Path

import pytest
import torch

from synfmc_tpu_torch.ops.flash_attention import fwd_instance

FLASH_FWD_CU = Path(__file__).resolve().parent.parent / "synfmc_tpu_torch" / "csrc" / "flash_fwd.cu"
# Head dims of every K1 launch on the flagship's serving and train paths:
# level 0 (D = 40) and level 1 (D = 80) of the UNet.
FLAGSHIP_HEAD_DIMS = (40, 80)


def cuda_instances() -> dict:
    """{D: instance} from flash_fwd.cu's SYNFMC_FWD_WGMMA (D, QK^T depth, PV's
    N) and SYNFMC_FWD_MMA (D rounded up to 16) tables."""
    src = FLASH_FWD_CU.read_text()
    wg = re.search(r"#define SYNFMC_FWD_WGMMA\(X\)(.*?)\n#define", src, re.S).group(1)
    mma = re.search(r"#define SYNFMC_FWD_MMA\(X\)(.*?)\n\n", src, re.S).group(1)
    table = {int(d): ("wgmma", int(k), int(n))
             for d, k, n in re.findall(r"X\((\d+), (\d+), (\d+)\)", wg)}
    for dp in map(int, re.findall(r"X\((\d+)\)", mma)):
        table.update({d: ("mma_sync", dp) for d in (dp - 8, dp)})
    return table


@pytest.mark.parametrize("d,want", [
    (8, ("wgmma", 16, 40)), (40, ("wgmma", 48, 40)), (48, ("wgmma", 48, 48)),
    (56, ("wgmma", 64, 64)), (80, ("wgmma", 80, 80)), (120, ("wgmma", 128, 128)),
    (128, ("wgmma", 128, 128)), (136, ("mma_sync", 144)), (256, ("mma_sync", 256)),
])
def test_fwd_instance_by_head_dim(d, want):
    """D <= 128 runs on wgmma with QK^T's depth rounded up to 16 and PV's N
    the smallest of wgmma.cuh's instances that holds D; larger D on mma.sync
    padded to 16; fp32 on its own kernel."""
    assert fwd_instance(d) == want
    assert fwd_instance(d, torch.float32) == ("f32",)


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_fwd_instance_matches_the_launcher_tables(d):
    """Every D the gate takes (a multiple of 8 up to 256) has one entry in
    the launcher's tables, and the mirror names it."""
    table = cuda_instances()
    assert sorted(table) == list(range(8, 257, 8))
    assert fwd_instance(d) == table[d]


def test_flagship_k1_keys_take_wgmma():
    for d in FLAGSHIP_HEAD_DIMS:
        assert fwd_instance(d)[0] == "wgmma"
