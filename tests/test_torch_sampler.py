"""The port's sampler modes and object conditioning against the JAX package.

Tiny width (as tests/test_torch_slice.py), the obj stage of configs/obj.yaml,
fp32 on the CPU, the same exported weights and numpy-seeded inputs on both
sides: the trajectory rasterizer and adapter inputs, the ObjectAdapter,
DPM-Solver++(2M), the UNet's DeepCache tensor and shallow step, the
denoise loop in every mode (exact with OMC, DPM++, DeepCache, CFG-cache,
turbo + DPM++, multidiff windows) and the chunked VAE decode.  Each mode
compiles the JAX package's own denoise_loop, most of this file's time; the
programs compile at backend optimisation level 0, which changes no result
here and shortens each compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.diffusion import DiffusionSchedule as JSchedule
from synfmc_tpu.geometry.plucker import plucker_embedding as jax_plucker
from synfmc_tpu.models.adapter import ObjectAdapter as JAdapter
from synfmc_tpu.pipelines.animation import decode_latents as jax_decode, denoise_loop as jax_denoise
from synfmc_tpu.utils.traj_features import (
    build_adapter_inputs as jax_adapter_inputs,
    rasterize_traj_features as jax_rasterize,
    traj_features_from_adapter as jax_traj_from_adapter,
)
from synfmc_tpu_torch.data.tokenizer import HashTokenizer
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.geometry.plucker import plucker_embedding
from synfmc_tpu_torch.interop.torch_port import load_jax_params
from synfmc_tpu_torch.pipelines.animation import decode_latents
from synfmc_tpu_torch.pipelines.factory import build_models, build_pipeline
from synfmc_tpu_torch.utils.traj_features import build_adapter_inputs, rasterize_traj_features
from tests.test_torch_modules import japply, randomize, shapes
from tests.test_torch_slice import TINY, jax_models, tiny_config

CHS = TINY["block_out_channels"]
F, H, W = 4, 64, 64          # one window; latents 8x8
MD_WINDOWS, MD_OVERLAP = 2, 2  # tests/test_pipeline.py:160: 2 * (4 - 2) + 2 = 6 frames
STEPS, OMCM = 3, 300          # t = 667, 334, 1: the OMC gate is off at the last step
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def obj_config():
    """The tiny obj stage, motion modules at level 0 only: the modes differ
    in how they sequence the levels, and each deeper motion module adds
    seconds to every JAX compile."""
    cfg = tiny_config()
    cfg["unet_additional_kwargs"]["motion_module_resolutions"] = [1]
    cfg["omcm_config"] = {"params": {"nums_rb": 2, "use_pre_zero_conv": True,
                                     "use_post_zero_conv": True}}
    return cfg


def sphere_masks(rng, f, o, h, w):
    """(1, f, o, h, w) Gaussian spheres: objects 0 and 1 overlap, the last
    object is an all-zero padding row."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    masks = np.zeros((1, f, o, h, w), np.float32)
    for j in range(o - 1):
        for i in range(f):
            cx, cy = w * (0.35 + 0.2 * j) + 2 * i, h * 0.5 + rng.uniform(-4, 4)
            r = h * 0.25
            d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            masks[0, i, j] = (d <= r) * np.exp(-0.5 * (d / (r / 2)) ** 2)
    return masks


def obj_inputs(rng, f=F):
    o = 3
    info = rng.normal(size=(1, f, o, 12)).astype(np.float32)
    info[:, :, -1] = 0.0
    return info, sphere_masks(rng, f, o, H, W)


@pytest.fixture(scope="module")
def case():
    """JAX modules with seeded weights and the JAX side of the shared inputs."""
    cfg = obj_config()
    models = jax_models(cfg)
    models["adapter"] = JAdapter(channels=tuple(CHS))
    key = jax.random.PRNGKey(0)
    pose0 = [jnp.zeros((1, F, H // 8 // 2**i, W // 8 // 2**i, c)) for i, c in enumerate(CHS)]
    params = {
        "unet": randomize(shapes(models["unet"], key, jnp.zeros((1, F, H // 8, W // 8, 4)),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                                 pose_features=pose0), seed=1),
        "vae": randomize(shapes(models["vae"], key, jnp.zeros((1, 32, 32, 3))), seed=2),
        "clip_text": randomize(shapes(models["clip_text"], key, jnp.zeros((1, 77), jnp.int32)),
                               seed=3),
        "pose_encoder": randomize(shapes(models["pose_encoder"], key,
                                         jnp.zeros((1, F, H, W, 6))), seed=4),
        "adapter": randomize(shapes(models["adapter"], key, jnp.zeros((F, H, W, 13)),
                                    jnp.zeros((F, H, W, 1))), seed=5),
    }
    rng = np.random.default_rng(6)
    info, masks = obj_inputs(rng)
    md_frames = MD_WINDOWS * (F - MD_OVERLAP) + MD_OVERLAP
    inputs = {
        "latents": rng.normal(size=(1, F, H // 8, W // 8, 4)).astype(np.float32),
        "md_latents": rng.normal(size=(1, md_frames, H // 8, W // 8, 4)).astype(np.float32),
        "obj_info": info, "obj_masks": masks,
    }
    for name, f in (("cam", F), ("md_cam", md_frames)):
        intr = np.broadcast_to(np.array([W, H, 0, 0], np.float32), (1, f, 4)).copy()
        c2w = np.tile(np.eye(4, dtype=np.float32), (1, f, 1, 1))
        c2w[..., 0, 3] = np.linspace(0.0, 0.6, f)
        inputs[name] = (intr, c2w)
    prompts = ["a turtle paddles through a coral reef"]
    context = japply(models["clip_text"], params["clip_text"],
                     jnp.asarray(HashTokenizer()([""] + prompts)))
    pose = {name: japply(models["pose_encoder"], params["pose_encoder"],
                         jax_plucker(*map(jnp.asarray, inputs[name]), H, W))
            for name in ("cam", "md_cam")}
    feats, mask = jax_adapter_inputs(jnp.asarray(info), jnp.asarray(masks))
    traj = jax_traj_from_adapter(models["adapter"], params["adapter"], feats, mask, F)
    return dict(cfg=cfg, models=models, params=params, inputs=inputs, prompts=prompts,
                context=context, pose=pose, traj=[np.asarray(t) for t in traj],
                schedule=JSchedule.from_config(**cfg["noise_scheduler_kwargs"]))


@pytest.fixture(scope="module")
def pipe(case):
    p, _ = build_pipeline(case["cfg"], stage="obj", device="cpu", seed=0, allow_untrained_cm=True)
    for name, module in (("unet", p.unet), ("vae", p.vae), ("clip_text", p.text_encoder),
                         ("pose_encoder", p.pose_encoder), ("adapter", p.adapter)):
        load_jax_params(module, case["params"][name], name)
    return p


def test_rasterize_traj_features_matches_jax():
    info, masks = obj_inputs(np.random.default_rng(1))
    assert (masks[0, :, 0] * masks[0, :, 1] > 0).any(), "objects 0 and 1 must overlap"
    want = jax_rasterize(jnp.asarray(info), jnp.asarray(masks))
    got = rasterize_traj_features(torch.from_numpy(info), torch.from_numpy(masks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # the last object wins where two overlap
    both = (masks[0, :, 0] > 0) & (masks[0, :, 1] > 0)
    np.testing.assert_array_equal(got[1][0, ..., 0].numpy()[both], masks[0, :, 1][both])


def test_build_adapter_inputs_matches_jax_and_drops_whole_samples():
    info, masks = obj_inputs(np.random.default_rng(2))
    want = jax_adapter_inputs(jnp.asarray(info), jnp.asarray(masks))
    got = build_adapter_inputs(torch.from_numpy(info), torch.from_numpy(masks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # dropout: each of 4 samples is kept whole or zeroed whole, as the
    # generator's uniform draws say
    info4, masks4 = (np.concatenate([x] * 4) for x in (info, masks))
    gen = torch.Generator().manual_seed(2)
    feats, mask = build_adapter_inputs(torch.from_numpy(info4), torch.from_numpy(masks4),
                                       generator=gen, cfg_dropout_ratio=0.5)
    keep = torch.rand((4,), generator=torch.Generator().manual_seed(2)) > 0.5
    assert 0 < int(keep.sum()) < 4, keep
    feats = feats.reshape(4, F, H, W, 13)
    full = got[0].reshape(1, F, H, W, 13)
    for i in range(4):
        np.testing.assert_array_equal(feats[i].numpy(), (full[0] if keep[i] else 0 * full[0]).numpy())
    np.testing.assert_array_equal(mask.reshape(4, F, H, W, 1)[0].numpy(), got[1].reshape(F, H, W, 1).numpy())


def test_object_adapter_matches_jax(case, pipe):
    feats, mask = build_adapter_inputs(torch.from_numpy(case["inputs"]["obj_info"]),
                                       torch.from_numpy(case["inputs"]["obj_masks"]))
    got = pipe.encode_traj(feats, mask, F)
    assert [tuple(t.shape) for t in got] == [t.shape for t in case["traj"]]
    assert np.abs(case["traj"][0]).max() > 0  # the 1x1 last scale samples background
    for g, w in zip(got, case["traj"]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-3)


def test_dpmpp_tables_and_step_match_jax(case):
    schedule = DiffusionSchedule.from_config(**case["cfg"]["noise_scheduler_kwargs"])
    for n in (1, 2, 3, 25):
        want = case["schedule"].dpmpp_2m_tables(n)
        got = schedule.dpmpp_2m_tables(n)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
    tables = schedule.dpmpp_2m_tables(STEPS)
    assert tables["c_d1"][0] == 0.0 and tables["c_d1"][-1] == 0.0
    rng = np.random.default_rng(7)
    eps, x, m_prev = (rng.normal(size=(1, 2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    for idx in range(STEPS):
        want = case["schedule"].dpmpp_2m_step(jnp.asarray(eps), idx, jnp.asarray(x),
                                              jnp.asarray(m_prev), tables)
        got = schedule.dpmpp_2m_step(torch.from_numpy(eps), idx, torch.from_numpy(x),
                                     torch.from_numpy(m_prev), tables)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_unet_deep_cache_matches_jax(case, pipe):
    """return_deep's tensor and the shallow step on it, at batch 2 with traj
    and pose features; the shallow step on the true cache is the full eps."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, F, H // 8, W // 8, 4)).astype(np.float32)
    ctx, t = case["context"], np.array([500, 500])
    pose = [np.concatenate([p, p]) for p in case["pose"]["cam"]]
    traj = [np.concatenate([np.zeros_like(tr), tr]) for tr in case["traj"]]
    unet, params = case["models"]["unet"], case["params"]["unet"]
    full = jax.jit(lambda *a: unet.apply(params, *a, return_deep=True))
    shallow = jax.jit(lambda *a, deep: unet.apply(params, *a, deep_cache=deep))
    j_eps, j_deep = full(x, t, ctx, pose, traj)
    j_shallow = shallow(x, t, ctx, pose, traj, deep=j_deep * 0.5)
    tt = lambda a: torch.from_numpy(np.array(a))
    args = (tt(x), tt(t), tt(ctx), [tt(p) for p in pose], [tt(tr) for tr in traj])
    with torch.inference_mode():
        eps, deep = pipe.unet(*args, return_deep=True)
        got_shallow = pipe.unet(*args, deep_cache=tt(j_deep) * 0.5)
        exact = pipe.unet(*args, deep_cache=deep)
    assert deep.shape == (2, F, H // 8, W // 8, CHS[1])
    np.testing.assert_allclose(deep.numpy(), np.asarray(j_deep), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(eps.numpy(), np.asarray(j_eps), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got_shallow.numpy(), np.asarray(j_shallow), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(exact.numpy(), eps.numpy(), atol=1e-5, rtol=0)


MODES = {
    "omc": dict(),
    "dpmpp": dict(solver="dpmpp_2m"),
    "deepcache2": dict(deepcache_interval=2),
    "cfgcache2": dict(cfg_cache_interval=2),
    "turbo2_dpmpp": dict(deepcache_interval=2, cfg_cache_interval=2, solver="dpmpp_2m"),
    "multidiff": dict(multidiff_total_steps=MD_WINDOWS, multidiff_overlaps=MD_OVERLAP),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_denoise_loop_matches_jax(case, pipe, mode):
    """The port's pipeline (pose encoder, adapter, denoise loop) against the
    JAX package's denoise_loop on the JAX encoders' features; every mode
    but multidiff carries the OMC traj features."""
    kw = MODES[mode]
    md = mode == "multidiff"
    inp = case["inputs"]
    lat = inp["md_latents"] if md else inp["latents"]
    pose = case["pose"]["md_cam" if md else "cam"]
    traj = None if md else case["traj"]
    loop_kw = dict(num_inference_steps=STEPS, guidance_scale=8.0, omcm_min_step=OMCM,
                   window_length=F, **kw)
    unet = case["models"]["unet"]
    fn = jax.jit(lambda p, l, c, po, tr: jax_denoise(unet, p, case["schedule"], l, c,
                                                     pose_features=po, traj_features=tr,
                                                     **loop_kw))
    args = (case["params"]["unet"], jnp.asarray(lat), jnp.asarray(case["context"]),
            [jnp.asarray(p) for p in pose], None if traj is None else [jnp.asarray(t) for t in traj])
    want = np.asarray(fn.lower(*args).compile(compiler_options=FAST)(*args))

    traj_t = None
    if not md:
        feats, mask = build_adapter_inputs(torch.from_numpy(inp["obj_info"]),
                                           torch.from_numpy(inp["obj_masks"]))
        traj_t = pipe.encode_traj(feats, mask, F)
    intr, c2w = inp["md_cam" if md else "cam"]
    got = pipe(case["prompts"], video_length=F, height=H, width=W, num_inference_steps=STEPS,
               guidance_scale=8.0, latents=torch.from_numpy(lat),
               plucker=plucker_embedding(torch.from_numpy(intr), torch.from_numpy(c2w), H, W),
               traj_features=traj_t, omcm_min_step=OMCM, decode=False, **kw)
    assert got.shape == lat.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_chunked_decode_matches_jax(case, pipe, monkeypatch):
    """6 frames with decode_chunk=4: the largest divisor, 3 frames a call."""
    lat = case["inputs"]["md_latents"][:, :, :4, :4]
    want = jax_decode(case["models"]["vae"], case["params"]["vae"], jnp.asarray(lat),
                      decode_chunk=4)
    calls, decode = [], pipe.vae.decode
    monkeypatch.setattr(pipe.vae, "decode", lambda z: (calls.append(z.shape[0]), decode(z))[1])
    with torch.inference_mode():
        got = decode_latents(pipe.vae, torch.from_numpy(lat), decode_chunk=4)
    assert calls == [3, 3]
    assert got.shape == (1, 6, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


def test_build_models_obj_stage_loads_every_jax_param(case):
    models = build_models(case["cfg"], stage="obj")
    assert set(models) == {"unet", "vae", "text", "pose_encoder", "adapter"}
    for name, key in (("unet", "unet"), ("vae", "vae"), ("text", "clip_text"),
                      ("pose_encoder", "pose_encoder"), ("adapter", "adapter")):
        load_jax_params(models[name], case["params"][key], key)  # strict=True
    with pytest.raises(ValueError, match="unknown stage"):
        build_models(case["cfg"], stage="video")
