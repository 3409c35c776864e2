"""The port's stage-2 train step against the JAX package's, on the CPU.

The tiny cam-stage config of test_torch_slice.py cut to two UNet levels
(32/64 channels, 4 heads, 2 CLIP layers, small VAE), which halves the JAX
compile, at 128x128 px, 2 frames, batch 2, fp32, with seeded random weights
carried into the port.  128x128 px gives level 0 256 tokens, so the step
reaches all three attention routes (flash at level 0, temporal in every
motion module, plain for cross-attention and the mid block).  The draws come from
one JAX key split as synfmc_tpu/training/steps.py:227-237 splits it, and the
port is handed the same values through its draw record: sample 0's camera
and sample 1's text are dropped, both captions are swapped for the
background ones, and sample 0 is horizontally flipped.

Tolerances: loss terms 1e-5 relative; each gradient within 1e-4 of its
largest magnitude plus 1e-3 relative (fp32 sums in another order through a
deep network); parameters after one clip + AdamW step on the same gradients
within 1e-6 + 1e-2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.diffusion import DiffusionSchedule as JSchedule
from synfmc_tpu.geometry.plucker import plucker_embedding as jax_plucker
from synfmc_tpu.ops.pixel import nearest_resize as jax_nearest_resize
from synfmc_tpu.training.optim import make_lr_schedule as jax_lr_schedule
from synfmc_tpu.training.optim import make_optimizer as jax_make_optimizer
from synfmc_tpu.training.params import partition_params as jax_partition
from synfmc_tpu.training.params import stage2_cmc_unet_trainable as jax_stage2
from synfmc_tpu.training.params import stage3_mm_trainable as jax_stage3_mm
from synfmc_tpu.training.steps import StepConfig as JStepConfig
from synfmc_tpu.training.steps import init_train_state as jax_init_state
from synfmc_tpu.training.steps import make_cam_grads_fn as jax_cam_grads_fn
from synfmc_tpu.training.steps import step_from_grads as jax_step_from_grads
from synfmc_tpu_torch.data.tokenizer import HashTokenizer
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.geometry.plucker import plucker_embedding
from synfmc_tpu_torch.interop.torch_port import jax_state_dict, load_jax_params, unet_path_to_torch
from synfmc_tpu_torch.ops.pixel import nearest_resize
from synfmc_tpu_torch.pipelines.factory import build_models
from synfmc_tpu_torch.training.optim import make_lr_schedule, make_optimizer
from synfmc_tpu_torch.training.params import (
    partition_params,
    stage2_cmc_unet_trainable,
    stage3_mm_trainable,
)
from synfmc_tpu_torch.training.steps import (
    CamDraws,
    StepConfig,
    apply_grads,
    init_train_state,
    make_cam_grads_fn,
)
from tests.test_torch_modules import randomize, shapes
from tests.test_torch_slice import jax_models, tiny_config

B, F, H, W = 2, 2, 128, 128
CHS = [32, 64]
LR = 1e-3
CFG = dict(cfg_random_null_text_ratio=0.5, background_caption_prob=1.0, apply_masked_loss=True,
           invert_loss_mask=True, mask_loss_weight=1.0, sd_loss_weight=0.6,
           appearance_debias=0.5, sample_height=H, sample_width=W)
KEY_SEED = 22  # its split drops sample 0's camera and sample 1's text (asserted below)


def _batch():
    rng = np.random.default_rng(11)
    tok = HashTokenizer()
    rt = np.tile(np.eye(4, dtype=np.float32)[:3].reshape(12), (B, F, 1))
    rt[..., 3] = np.linspace(0.0, 0.5, F)
    rt[1, :, 11] = 0.2
    mask = np.zeros((B, F, H, W, 1), np.float32)
    mask[:, :, 32:96, 40:100] = 1.0
    return {
        "pixel_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
        "input_ids": tok(["a knight marches across a field", "a blue dragon soars"]),
        "background_ids": tok(["a grassy field", "an empty sky"]),
        "null_ids": tok([""])[0],
        "camera_rt": rt,
        "intrinsics": np.tile(np.array([W, H, 0, 0], np.float32), (B, F, 1)),
        "obj_union_mask": mask,
        "flip_flag": np.array([True, False]),
    }


def _draws(key, cfg):
    """The JAX step's draws (steps.py:227-237 and the functions it calls)."""

    @jax.jit
    def draw(key):
        r = jax.random.split(key, 8)
        lat = (B, F, H // 8, W // 8, 4)
        return {
            "use_background": jax.random.uniform(r[0]) < cfg.background_caption_prob,
            "text_drop": jax.random.uniform(r[1], (B,)) < cfg.cfg_random_null_text_ratio,
            "camera_drop": jax.random.uniform(r[2], (B,)) < cfg.cfg_random_null_text_ratio,
            "vae_eps": jax.random.normal(r[3], (B * F, *lat[2:]), jnp.float32),
            "noise": jax.random.normal(r[4], lat, jnp.float32),
            "timesteps": jax.random.randint(r[5], (B,), 0, 1000),
            "anchor": jax.random.randint(r[7], (B,), 0, F),
        }

    return CamDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draw(key).items()})


def two_level_config():
    cfg = tiny_config()
    cfg["model_overrides"]["block_out_channels"] = CHS
    return cfg


@pytest.fixture(scope="module")
def step_case():
    cfg = two_level_config()
    models = jax_models(cfg, CHS)
    key = jax.random.PRNGKey(0)
    pose0 = [jnp.zeros((1, F, H // 8 // 2**i, W // 8 // 2**i, c)) for i, c in enumerate(CHS)]
    params = {
        "unet": randomize(shapes(models["unet"], key, jnp.zeros((1, F, H // 8, W // 8, 4)),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                                 pose_features=pose0), seed=1)["params"],
        "vae": randomize(shapes(models["vae"], key, jnp.zeros((1, 32, 32, 3))), seed=2)["params"],
        "clip_text": randomize(shapes(models["clip_text"], key, jnp.zeros((1, 77), jnp.int32)),
                               seed=3)["params"],
        "pose_encoder": randomize(shapes(models["pose_encoder"], key,
                                         jnp.zeros((1, F, H, W, 6))), seed=4)["params"],
    }
    jcfg = JStepConfig(**CFG)
    schedule = JSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    t_unet, f_unet = jax_partition(params["unet"], jax_stage2)
    trainable = {"unet": t_unet, "pose_encoder": params["pose_encoder"]}
    frozen = {"unet": f_unet, "vae": {"params": params["vae"]},
              "text": {"params": params["clip_text"]}}
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(KEY_SEED)
    grads_fn = jax_cam_grads_fn(models["unet"], models["pose_encoder"], models["vae"],
                                models["clip_text"], schedule, jcfg)
    tx = jax_make_optimizer(LR)

    def grads_and_step(trainable, frozen, batch, rng):
        """The grads, and one clip + AdamW step on them through the JAX
        package's own step_from_grads."""
        grads, metrics = grads_fn(trainable, frozen, batch, rng)
        step = jax_step_from_grads(lambda *_: (grads, metrics), tx)
        state, _ = step(jax_init_state(trainable, tx), frozen, batch, rng)
        return grads, metrics, state.trainable

    # one program; backend optimisation level 0 halves the CPU compile and
    # changes no result here
    compiled = jax.jit(grads_and_step).lower(trainable, frozen, jbatch, rng).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    grads, metrics, stepped = compiled(trainable, frozen, jbatch, rng)
    return dict(cfg=cfg, params=params, batch=batch, draws=_draws(rng, jcfg), grads=grads,
                metrics={k: float(v) for k, v in metrics.items()}, stepped=stepped)


def _port_step(case):
    models = build_models(case["cfg"])
    for name, key in (("unet", "unet"), ("vae", "vae"), ("text", "clip_text"),
                      ("pose_encoder", "pose_encoder")):
        load_jax_params(models[name], case["params"][key], key)
    trainable = {**partition_params(models["unet"], stage2_cmc_unet_trainable, "unet."),
                 **partition_params(models["pose_encoder"], lambda n: True, "pose_encoder.")}
    for name in ("vae", "text"):
        partition_params(models[name], lambda n: False)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in case["batch"].items()}
    for k in ("input_ids", "background_ids", "null_ids"):
        batch[k] = batch[k].long()
    schedule = DiffusionSchedule.from_config(**case["cfg"]["noise_scheduler_kwargs"])
    grads_fn = make_cam_grads_fn(models["unet"], models["pose_encoder"], models["vae"],
                                 models["text"], schedule, StepConfig(**CFG))
    grads, metrics = grads_fn(trainable, batch, case["draws"])
    return trainable, {n: g.clone() for n, g in grads.items()}, metrics


@pytest.fixture(scope="module")
def port_step(step_case):
    return _port_step(step_case)


def _jax_named(tree):
    return {**{"unet." + k: v for k, v in jax_state_dict(tree["unet"], "unet").items()},
            **{"pose_encoder." + k: v
               for k, v in jax_state_dict(tree["pose_encoder"], "pose_encoder").items()}}


def test_draws_cover_the_dropout_branches(step_case):
    d = step_case["draws"]
    assert bool(d.use_background)
    assert d.camera_drop.tolist() == [True, False] and d.text_drop.tolist() == [False, True]


def test_cam_grads_match_jax(step_case, port_step):
    _, grads, metrics = port_step
    for k in ("loss", "sd_loss", "mask_loss"):
        np.testing.assert_allclose(float(metrics[k]), step_case["metrics"][k], rtol=1e-5,
                                   err_msg=k)
    want = _jax_named(step_case["grads"])
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-3,
                                   err_msg=name)


def test_optimizer_step_matches_jax(step_case, port_step):
    """JAX's gradients through both optimizers: the port's clip + AdamW step
    against step_from_grads with make_optimizer."""
    trainable, _, _ = port_step
    grads = {n: torch.from_numpy(g.copy()) for n, g in _jax_named(step_case["grads"]).items()}
    state = init_train_state(trainable, make_optimizer(LR))
    apply_grads(state, grads)
    assert state.step == 1
    want = _jax_named(step_case["stepped"])
    for name, p in trainable.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6 + 1e-2 * LR,
                                   rtol=0, err_msg=name)


def test_stage2_partition_matches_jax(step_case):
    """JAX's path rules and the port's name rules pick the same tensors."""
    from flax.traverse_util import flatten_dict

    cfg = dict(step_case["cfg"], train_mm=True)
    flat = flatten_dict(step_case["params"]["unet"])
    for jrule, rule in ((jax_stage2, stage2_cmc_unet_trainable),
                        (jax_stage3_mm, stage3_mm_trainable)):
        want = {unet_path_to_torch(k) for k in flat if jrule("/".join(k))}
        got = set(partition_params(build_models(cfg)["unet"], rule))
        assert got == want and got


@pytest.mark.parametrize("scheduler,warmup", [("constant", 0), ("linear", 3), ("cosine", 2)])
def test_lr_schedule_matches_optax(scheduler, warmup):
    want = jax_lr_schedule(1e-4, scheduler, warmup, 10)
    got = make_lr_schedule(1e-4, scheduler, warmup, 10)
    for count in range(13):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)


def test_flip_flag_matches_jax(rng):
    b, f, h, w = 2, 3, 8, 12
    intr = np.broadcast_to(np.array([w, h, 1.5, 2.0], np.float32), (b, f, 4)).copy()
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, f, 1, 1))
    c2w[..., :3, 3] = rng.normal(size=(b, f, 3))
    flip = np.array([True, False])
    want = np.asarray(jax_plucker(jnp.asarray(intr), jnp.asarray(c2w), h, w,
                                  flip_flag=jnp.asarray(flip)))
    got = plucker_embedding(torch.from_numpy(intr), torch.from_numpy(c2w), h, w,
                            flip_flag=torch.from_numpy(flip))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    unflipped = plucker_embedding(torch.from_numpy(intr), torch.from_numpy(c2w), h, w)
    np.testing.assert_array_equal(got[1].numpy(), unflipped[1].numpy())
    assert not np.allclose(got[0].numpy(), unflipped[0].numpy())


@pytest.mark.parametrize("size", [(16, 16), (5, 7), (40, 24)])
def test_nearest_resize_matches_jax(rng, size):
    x = rng.normal(size=(2, 20, 12, 1)).astype(np.float32)
    want = np.asarray(jax_nearest_resize(jnp.asarray(x), *size))
    np.testing.assert_array_equal(nearest_resize(torch.from_numpy(x), *size).numpy(), want)


def test_add_noise_matches_jax(rng):
    kw = dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012)
    x0, noise = (rng.normal(size=(3, 2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 412, 999])
    want = np.asarray(JSchedule.from_config(**kw).add_noise(jnp.asarray(x0), jnp.asarray(noise),
                                                            jnp.asarray(t)))
    got = DiffusionSchedule.from_config(**kw).add_noise(torch.from_numpy(x0),
                                                        torch.from_numpy(noise),
                                                        torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_train_requires_gpu_unless_cpu_asked(monkeypatch):
    from synfmc_tpu_torch.training.trainers import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("cam", two_level_config(), iter([]), 1)
