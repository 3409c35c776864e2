"""The port's serving path end to end against the JAX package, and the port's
independence from JAX.

Tiny width (UNet channels 32/64/128/128, 4 heads, 2 CLIP layers, small VAE),
the cam-stage config of configs/cam.yaml otherwise.  Prompts -> CLIP ->
Plücker -> pose encoder -> 3 DDIM steps with traj features and
omcm_min_step=300 (the gate switches off for the last step) -> decode, with
the same weights and initial latents on both sides, fp32 on the CPU.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.diffusion import DiffusionSchedule as JSchedule
from synfmc_tpu.geometry.plucker import plucker_embedding as jax_plucker
from synfmc_tpu.models.clip_text import CLIPTextModel as JCLIP
from synfmc_tpu.models.pose_encoder import CameraPoseEncoder as JPose
from synfmc_tpu.models.unet3d import UNet3D as JUNet, unet_config_from_yaml as jax_unet_cfg
from synfmc_tpu.models.vae import AutoencoderKL as JVAE
from synfmc_tpu.pipelines.animation import decode_latents as jax_decode, denoise_loop as jax_denoise
from synfmc_tpu_torch.data.tokenizer import HashTokenizer
from synfmc_tpu_torch.interop.torch_port import load_jax_params
from synfmc_tpu_torch.pipelines.factory import build_models, build_pipeline, load_config
from tests.test_torch_modules import japply, randomize, shapes

REPO = Path(__file__).resolve().parent.parent
TINY = {
    "block_out_channels": [32, 64, 128, 128],
    "cross_attention_dim": 64,
    "attn_heads": 4,
    "text": {"vocab_size": 49408, "hidden_size": 64, "num_layers": 2, "num_heads": 4},
    "vae_channels": [32, 32, 64, 64],
}


def tiny_config():
    cfg = load_config(str(REPO / "configs" / "cam.yaml"))
    cfg["model_overrides"] = dict(TINY)
    cfg["unet_additional_kwargs"]["motion_module_kwargs"]["num_attention_heads"] = 4
    cfg["pose_encoder_kwargs"]["temporal_attention_nhead"] = 4
    cfg["mixed_precision_training"] = False
    return cfg


def jax_models(cfg, block_out_channels=TINY["block_out_channels"]):
    """The same modules built the JAX package's way (trainers.build_models)."""
    chs = tuple(block_out_channels)
    unet = JUNet(block_out_channels=chs, attn_heads=4, cross_attention_dim=64,
                 **jax_unet_cfg(cfg["unet_additional_kwargs"], lora_rank=cfg["lora_rank"],
                                lora_scale=cfg["lora_scale"], camera_cond=True))
    return {
        "unet": unet,
        "vae": JVAE(block_out_channels=tuple(TINY["vae_channels"])),
        "clip_text": JCLIP(**TINY["text"]),
        "pose_encoder": JPose(channels=chs, temporal_attention_nhead=4,
                              temporal_pe_max_len=16),
    }


@pytest.fixture(scope="module")
def slice_case():
    cfg = tiny_config()
    models = jax_models(cfg)
    b, f, h, w = 1, 4, 64, 64
    chs = TINY["block_out_channels"]
    key = jax.random.PRNGKey(0)
    pose0 = [jnp.zeros((1, f, h // 8 // 2**i, w // 8 // 2**i, c)) for i, c in enumerate(chs)]
    params = {
        "unet": randomize(shapes(models["unet"], key, jnp.zeros((1, f, h // 8, w // 8, 4)),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                                 pose_features=pose0), seed=1),
        "vae": randomize(shapes(models["vae"], key, jnp.zeros((1, 32, 32, 3))), seed=2),
        "clip_text": randomize(shapes(models["clip_text"], key, jnp.zeros((1, 77), jnp.int32)),
                               seed=3),
        "pose_encoder": randomize(shapes(models["pose_encoder"], key,
                                         jnp.zeros((1, f, h, w, 6))), seed=4),
    }
    rng = np.random.default_rng(5)
    latents = rng.normal(size=(b, f, h // 8, w // 8, 4)).astype(np.float32)
    traj = [rng.normal(size=(b, f, h // 8 // 2**i, w // 8 // 2**i, c)).astype(np.float32) * 0.3
            for i, c in enumerate(chs)]
    intr = np.broadcast_to(np.array([w, h, 0, 0], np.float32), (b, f, 4)).copy()
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, f, 1, 1))
    c2w[..., 0, 3] = np.linspace(0.0, 0.6, f)  # a pan along x
    prompts = ["a knight marches across a field"]
    inputs = dict(prompts=prompts, latents=latents, traj=traj, intr=intr, c2w=c2w, hw=(h, w))

    # JAX reference: the serving path of synfmc_tpu.pipelines.animation
    ids = HashTokenizer()([""] + prompts)
    context = japply(models["clip_text"], params["clip_text"], jnp.asarray(ids))
    plucker = jax_plucker(jnp.asarray(intr), jnp.asarray(c2w), h, w)
    pose = japply(models["pose_encoder"], params["pose_encoder"], plucker)
    schedule = JSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    lat = jax_denoise(models["unet"], params["unet"], schedule, jnp.asarray(latents),
                      jnp.asarray(context), pose_features=[jnp.asarray(p) for p in pose],
                      traj_features=[jnp.asarray(tr) for tr in traj], num_inference_steps=3,
                      guidance_scale=8.0, omcm_min_step=300)
    images = jax_decode(models["vae"], params["vae"], lat)
    return cfg, params, inputs, np.asarray(lat), np.asarray(images)


def test_slice_matches_jax_pipeline(slice_case):
    cfg, params, inputs, want_lat, want_img = slice_case
    pipe, _ = build_pipeline(cfg, device="cpu", seed=0)
    assert pipe.unet.dtype == torch.float32
    for name, module in (("unet", pipe.unet), ("vae", pipe.vae),
                         ("clip_text", pipe.text_encoder), ("pose_encoder", pipe.pose_encoder)):
        load_jax_params(module, params[name], name)
    from synfmc_tpu_torch.geometry.plucker import plucker_embedding

    h, w = inputs["hw"]
    plucker = plucker_embedding(torch.from_numpy(inputs["intr"]), torch.from_numpy(inputs["c2w"]),
                                h, w)
    kw = dict(video_length=4, height=h, width=w, num_inference_steps=3, guidance_scale=8.0,
              latents=torch.from_numpy(inputs["latents"]), plucker=plucker,
              traj_features=[torch.from_numpy(tr) for tr in inputs["traj"]], omcm_min_step=300)
    lat = pipe(inputs["prompts"], decode=False, **kw)
    np.testing.assert_allclose(lat.numpy(), want_lat, atol=1e-3, rtol=0)
    images = pipe(inputs["prompts"], **kw)
    assert images.shape == (1, 4, h, w, 3)
    np.testing.assert_allclose(images.numpy(), want_img, atol=2e-3, rtol=0)


def test_build_models_matches_jax_structure(slice_case):
    """The factory builds exactly the JAX package's parameter sets."""
    cfg, params, _, _, _ = slice_case
    models = build_models(cfg)
    for name, key in (("unet", "unet"), ("vae", "vae"), ("text", "clip_text"),
                      ("pose_encoder", "pose_encoder")):
        load_jax_params(models[name], params[key], key)  # strict=True


@pytest.fixture(scope="module")
def tiny_pipe():
    return build_pipeline(tiny_config(), device="cpu")[0]


@pytest.mark.parametrize("kw,match", [
    (dict(deepcache_interval=2, cfg_cache_interval=3), "equal intervals"),
    (dict(deepcache_interval=2, multidiff_total_steps=2, multidiff_overlaps=1),
     "multidiff_total_steps == 1"),
    (dict(traj_features=[torch.zeros(1)], multidiff_total_steps=2, multidiff_overlaps=1),
     "object conditioning"),
    (dict(solver="euler"), "unknown solver"),
], ids=["unequal_intervals", "cache_with_multidiff", "omc_with_multidiff", "unknown_solver"])
def test_refused_modes_raise(tiny_pipe, kw, match):
    """Where the JAX sampler asserts, the port raises ValueError before any work."""
    with pytest.raises(ValueError, match=match):
        tiny_pipe("x", video_length=2, height=64, width=64, latents=torch.zeros(1, 3, 8, 8, 4),
                  **kw)


# The card's machine has none of the third-party readers and writers the JAX
# package uses (transformers' CLIPTokenizer, safetensors, imageio, PIL, regex,
# ftfy): the port has its own, and must not reach for them.
_NOT_ON_THE_CARD = ("transformers", "safetensors", "imageio", "PIL", "regex", "ftfy")
_FORBIDDEN_ROOTS = ("jax", "flax", "synfmc_tpu") + _NOT_ON_THE_CARD
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(" + "|".join(_FORBIDDEN_ROOTS) + r")(?![\w])", re.M)


def test_port_imports_no_jax():
    sources = sorted((REPO / "synfmc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [str(p) for p in sources if _FORBIDDEN.search(p.read_text())]
    assert not bad, f"JAX-package or third-party reader imports in {bad}"
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in (REPO / "synfmc_tpu_torch").rglob("*.py")]
    modules = [m.removesuffix(".__init__") for m in modules]
    assert "synfmc_tpu_torch.scripts.generate" in modules
    assert "synfmc_tpu_torch.scripts.serve" in modules
    assert "synfmc_tpu_torch.scripts.train" in modules
    assert "synfmc_tpu_torch.data.dataset" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN_ROOTS!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
