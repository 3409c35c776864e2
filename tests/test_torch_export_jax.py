"""The port's exported serving program (synfmc_tpu_torch/scripts/
export_serving.py) against the JAX package's live serve composition (text
encode, pose encode, denoise_loop, decode_latents; scripts/export_serving.py's
``serve``) with the same weights, carried through interop/torch_port.py:
the tiny fp32 program with DeepCache 2, CFG-cache 2 and DPM-Solver++(2M) on
the CPU, frames within 2e-3 (the bound of tests/test_torch_slice.py).  The
save and load round trip is tests/test_torch_export.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.config import ConfigDict
from synfmc_tpu.diffusion import DiffusionSchedule as JSchedule
from synfmc_tpu.pipelines.animation import decode_latents as jax_decode
from synfmc_tpu.pipelines.animation import denoise_loop as jax_denoise
from synfmc_tpu.training.trainers import build_models as jax_build_models
from synfmc_tpu_torch.interop.torch_port import load_jax_params
from synfmc_tpu_torch.scripts import export_serving as es
from tests.test_torch_export import FLAGS
from tests.test_torch_modules import randomize, shapes

JAX_TOL = 2e-3  # tests/test_torch_slice.py's bound on decoded frames
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jax_case(args, shapes_):
    """The JAX script's cam-stage models at --tiny with randomized params
    (every conditioning path live), and its serve composition on the verify
    inputs."""
    cfg = ConfigDict({"unet_additional_kwargs": {"use_motion_module": True},
                      "model_overrides": es.TINY})
    models = jax_build_models(cfg, "cam")
    f, h, w = shapes_["frames"], shapes_["height"], shapes_["width"]
    chs = es.TINY["block_out_channels"]
    key = jax.random.PRNGKey(0)
    pose0 = [jnp.zeros((1, f, h // 8 // 2**i, w // 8 // 2**i, c)) for i, c in enumerate(chs)]
    params = {
        "unet": randomize(shapes(models["unet"], key, jnp.zeros((1, f, h // 8, w // 8, 4)),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)),
                                 pose_features=pose0), seed=1),
        "vae": randomize(shapes(models["vae"], key, jnp.zeros((1, 32, 32, 3))), seed=2),
        "clip_text": randomize(shapes(models["text"], key, jnp.zeros((1, 77), jnp.int32)), seed=3),
        "pose_encoder": randomize(shapes(models["pose_encoder"], key,
                                         jnp.zeros((1, f, h, w, 6))), seed=4),
    }
    schedule = JSchedule.from_config()

    def serve(params, ids, lat, plk):
        context = models["text"].apply(params["clip_text"], ids)
        pose = models["pose_encoder"].apply(params["pose_encoder"], plk)
        out = jax_denoise(models["unet"], params["unet"], schedule, lat, context,
                          pose_features=pose, num_inference_steps=shapes_["num_inference_steps"],
                          guidance_scale=args.guidance_scale, deepcache_interval=args.deepcache,
                          cfg_cache_interval=args.cfg_cache, solver=args.solver)
        return jax_decode(models["vae"], params["vae"], out)

    ids, lat, plk = (np.asarray(t) for t in es.sample_inputs(shapes_, "cpu", seed=7))
    inputs = (params, jnp.asarray(ids, jnp.int32), jnp.asarray(lat), jnp.asarray(plk))
    # one program at backend optimisation level 0 (as tests/test_torch_sampler.py): same values
    compiled = jax.jit(serve).lower(*inputs).compile(compiler_options=FAST)
    return params, np.asarray(compiled(*inputs))


@pytest.fixture(scope="module")
def exported():
    """The program of scripts/export_serving.py with FLAGS, its weights those
    of the JAX case, exported; the JAX frames."""
    args = es.parse_args(["--out", "unused.pt2", *FLAGS])
    program, shapes_ = es.build_program(args, torch.device("cpu"))
    params, want = _jax_case(args, shapes_)
    for name, module in (("unet", program.unet), ("vae", program.vae),
                         ("clip_text", program.text), ("pose_encoder", program.pose_encoder)):
        load_jax_params(module, params[name], name)
    ep = es.export_program(program, es.sample_inputs(shapes_, "cpu"))
    return dict(ep=ep, program=program, shapes=shapes_, jax_frames=want)


def test_graph_holds_the_kernel_ops(exported):
    """At 64x128 no self-attention reaches 256 tokens: K2 and K3 only."""
    targets = {str(n.target) for n in exported["ep"].graph.nodes if n.op == "call_function"}
    assert {"synfmc.temporal_attention_fwd.default", "synfmc.fused_group_norm_fwd.default"} \
        <= targets


def test_exported_program_matches_jax_serve(exported):
    inputs = es.sample_inputs(exported["shapes"], "cpu", seed=7)
    with torch.no_grad():
        got = exported["ep"].module()(*inputs).numpy()
        live = exported["program"](*inputs).numpy()
    want = exported["jax_frames"]
    assert got.shape == want.shape == (1, 4, 64, 128, 3)
    np.testing.assert_array_equal(got, live)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=0)
