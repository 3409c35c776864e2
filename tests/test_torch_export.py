"""The kernels as torch.library ops, and the port's serving export command
line (synfmc_tpu_torch/scripts/export_serving.py).

- ``torch.library.opcheck`` on each of the five ``synfmc::`` ops with CPU
  samples (schema, fake tensors, autograd registration, AOT dispatch);
- the tiny fp32 export on the CPU with DeepCache 2, CFG-cache 2 and
  DPM-Solver++(2M) and --verify, as tests/test_export_serving.py runs the JAX
  script (in process): the program loaded back against the live one within
  1e-5, and again after a second seeded weight set is loaded into both.

tests/test_torch_export_jax.py holds the exported frames to the JAX
package's serve composition."""

import json
import os

import numpy as np
import pytest
import torch

from synfmc_tpu_torch.ops import _library
from synfmc_tpu_torch.scripts import export_serving as es

FLAGS = ["--tiny", "--cpu", "--deepcache", "2", "--cfg-cache", "2", "--solver", "dpmpp_2m",
         "--verify"]
LOADED_TOL = 1e-5


def _t(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _op_samples():
    rng = np.random.default_rng(0)
    q, k, v, do = (_t(rng, 2, 256, 32) for _ in range(4))
    tq, tk, tv, tdo = (_t(rng, 8, 16, 32) for _ in range(4))
    x, w, b = _t(rng, 2, 64, 32), 1 + 0.1 * _t(rng, 32), 0.1 * _t(rng, 32)
    return [
        ("flash_attention_fwd", (q, k, v, 0.25, 4, True)),
        ("flash_attention_fwd", (q, k, v, 0.25, 4, False)),
        ("flash_attention_bwd", (q, k, v, _t(rng, 2, 256, 32), _t(rng, 2, 4, 256), do, 0.25, 4)),
        ("temporal_attention_fwd", (tq, tk, tv, 0.3, 4)),
        ("temporal_attention_bwd", (tq, tk, tv, tdo, 0.3, 4)),
        ("fused_group_norm_fwd", (x, w, b, 8, 1e-5, "silu")),
        ("fused_group_norm_fwd", (x, w, b, 8, 1e-6, None)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_opcheck(case):
    name, args = _op_samples()[case]
    result = torch.library.opcheck(_library.op(name), args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_are_registered_with_every_implementation():
    assert set(_library.IMPLS) == {"flash_attention_fwd", "flash_attention_bwd",
                                   "temporal_attention_fwd", "temporal_attention_bwd",
                                   "fused_group_norm_fwd"}
    for name, impls in _library.IMPLS.items():
        assert set(impls) == {"cpu", "cuda"}, name
        assert torch._C._dispatch_has_kernel_for_dispatch_key(f"synfmc::{name}", "CUDA")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(f"synfmc::{name}", "Meta")


def test_export_command_line_verifies(tmp_path, capsys):
    out = str(tmp_path / "fmc_serve.pt2")
    assert es.main(["--out", out, *FLAGS]) == 0
    body = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert body["verify_ok"], body
    assert body["verify_max_err"] < LOADED_TOL
    assert body["verify_swap_max_err"] < LOADED_TOL
    assert body["verify_swap_changed"] > 0.01  # the second weight set reached the loaded program
    assert os.path.getsize(out) == body["bytes"] > 1000
    assert body["platforms"] == ["cpu"] and body["parameters"] > 1_000_000
    assert body["deepcache_interval"] == 2 and body["cfg_cache_interval"] == 2
    assert body["solver"] == "dpmpp_2m"
    assert (body["height"], body["width"], body["frames"], body["num_inference_steps"]) == \
        (64, 128, 4, 2)
