"""The port's stage-1 (image LoRA) and stage-3 (OMC) train steps against the
JAX package's, on the CPU.

The two-level config of tests/test_torch_train.py (UNet 32/64, 4 heads, 2
CLIP layers, small VAE; 128x128 px, so level 0 has 256 tokens and takes the
flash route), fp32, with seeded random weights carried into the port:
- stage 1: batch 2 single frames, LoRA rank rule of configs/cam.yaml, no
  motion modules and no pose merges; sample 1's text is dropped;
- stage 3: batch 2, 2 frames, 3 padded objects with sphere masks, the
  ObjectAdapter into the UNet, the pose encoder trainable (train_cm) in the
  JAX program; the port runs it both trainable and frozen (no gradients,
  the adapter's the same); sample 1's text and sample 0's adapter input are
  dropped, one timestep is drawn high and one low.
The draws come from one JAX key split as synfmc_tpu/training/steps.py splits
it for each stage, handed to the port through LoraDraws / ObjDraws.  Each
JAX grads function is compiled once (XLA backend optimisation level 0).

Also: the stage predicates, the biased timestep sampler, the stage-1
dataset and its loader order, and each stage's parameter names and counts
against the JAX package's.

Tolerances as tests/test_torch_train.py: loss terms 1e-5 relative; each
gradient within 1e-4 of its largest magnitude plus 1e-3 relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from synfmc_tpu.config import ConfigDict
from synfmc_tpu.data.dataset import UnrealTrajLoraDataset as JLoraDataset
from synfmc_tpu.data.loader import ShardedLoader as JLoader
from synfmc_tpu.diffusion import DiffusionSchedule as JSchedule
from synfmc_tpu.training.params import partition_params as jax_partition
from synfmc_tpu.training.params import stage1_lora_trainable as jax_stage1
from synfmc_tpu.training.params import stage3_unet_trainable as jax_stage3
from synfmc_tpu.training.steps import StepConfig as JStepConfig
from synfmc_tpu.training.steps import make_lora_grads_fn as jax_lora_grads_fn
from synfmc_tpu.training.steps import make_obj_grads_fn as jax_obj_grads_fn
from synfmc_tpu.training.trainers import build_models as jax_build_models
from synfmc_tpu_torch.data.dataset import UnrealTrajLoraDataset
from synfmc_tpu_torch.data.fixture import build_synthetic_dataset
from synfmc_tpu_torch.data.loader import ShardedLoader
from synfmc_tpu_torch.data.tokenizer import HashTokenizer
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.interop.torch_port import jax_state_dict, load_jax_params, unet_path_to_torch
from synfmc_tpu_torch.pipelines.factory import build_models
from synfmc_tpu_torch.training.params import (
    partition_params,
    stage1_lora_trainable,
    stage3_unet_trainable,
)
from synfmc_tpu_torch.training.steps import (
    LoraDraws,
    ObjDraws,
    StepConfig,
    make_lora_grads_fn,
    make_obj_grads_fn,
)
from tests.test_torch_data import assert_same_item
from tests.test_torch_modules import randomize, shapes
from tests.test_torch_sampler import sphere_masks
from tests.test_torch_train import two_level_config

B, F, H, W, O = 2, 2, 128, 128, 3
CHS = [32, 64]
XDIM = 64
LORA_CFG = dict(cfg_random_null_text_ratio=0.5, sample_height=H, sample_width=W)
OBJ_CFG = dict(cfg_random_null_text_ratio=0.5, background_caption_prob=1.0,
               apply_masked_loss=True, invert_loss_mask=False, mask_loss_weight=1.0,
               sd_loss_weight=0.3, appearance_debias=0.5, cfg_random_null_om_ratio=0.5,
               omcm_min_step=700, min_step_prob=0.5, sample_height=H, sample_width=W)
LORA_KEY, OBJ_KEY = 11, 27  # their splits cover the dropout branches (asserted below)
COMPILE = {"xla_backend_optimization_level": 0}


def jax_params(cfg: dict, stage: str, f: int) -> tuple[dict, dict]:
    """The JAX package's modules for ``stage`` and seeded random params at
    the shapes its init_params gives them (trainers.py:162-201)."""
    models = jax_build_models(ConfigDict(cfg), stage)
    key = jax.random.PRNGKey(0)
    chs = models["unet"].block_out_channels
    pose = ([jnp.zeros((1, f, H // 8 // 2**i, W // 8 // 2**i, c)) for i, c in enumerate(chs)]
            if stage != "lora" else None)
    params = {
        "unet": shapes(models["unet"], key, jnp.zeros((1, f, H // 8, W // 8, 4)),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, XDIM)), pose_features=pose),
        "vae": shapes(models["vae"], key, jnp.zeros((1, 32, 32, 3))),
        "clip_text": shapes(models["text"], key, jnp.zeros((1, 77), jnp.int32)),
    }
    if stage != "lora":
        params["pose_encoder"] = shapes(models["pose_encoder"], key, jnp.zeros((1, f, H, W, 6)))
    if stage == "obj":
        params["adapter"] = shapes(models["adapter"], key, jnp.zeros((f, H, W, 13)),
                                   jnp.zeros((f, H, W, 1)))
    return models, {k: randomize(v, seed=i + 1)["params"] for i, (k, v) in
                    enumerate(params.items())}


def port_models(cfg: dict, stage: str, params: dict) -> dict:
    models = build_models(cfg, stage)
    for name, module in models.items():
        kind = "clip_text" if name == "text" else name
        load_jax_params(module, params[kind], kind)
    return models


def _batch(stage: str) -> dict:
    rng = np.random.default_rng(11)
    tok = HashTokenizer()
    out = {"input_ids": tok(["a knight marches across a field", "a blue dragon soars"]),
           "null_ids": tok([""])[0]}
    if stage == "lora":
        out["pixel_values"] = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
        return out
    rt = np.tile(np.eye(4, dtype=np.float32)[:3].reshape(12), (B, F, 1))
    rt[..., 3] = np.linspace(0.0, 0.5, F)
    rt[1, :, 11] = 0.2
    info = rng.normal(size=(B, F, O, 12)).astype(np.float32)
    info[:, :, -1] = 0.0  # a padding object
    out.update(
        pixel_values=rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
        background_ids=tok(["a grassy field", "an empty sky"]),
        camera_rt=rt,
        intrinsics=np.tile(np.array([W, H, 0, 0], np.float32), (B, F, 1)),
        flip_flag=np.array([True, False]),
        obj_info=info,
        obj_masks=np.concatenate([sphere_masks(rng, F, O, H, W) for _ in range(B)]),
    )
    return out


def _torch_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in ("input_ids", "background_ids", "null_ids"):
        if k in out:
            out[k] = out[k].long()
    return out


def _lora_draws(key) -> LoraDraws:
    """The JAX stage-1 step's draws (steps.py:183-192)."""

    @jax.jit
    def draw(key):
        r = jax.random.split(key, 8)
        lat = (B, 1, H // 8, W // 8, 4)
        ratio = LORA_CFG["cfg_random_null_text_ratio"]
        return {"text_drop": jax.random.uniform(r[1], (B,)) < ratio,
                "vae_eps": jax.random.normal(r[3], (B, *lat[2:]), jnp.float32),
                "noise": jax.random.normal(r[4], lat, jnp.float32),
                "timesteps": jax.random.randint(r[5], (B,), 0, 1000)}

    return LoraDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draw(key).items()})


def _obj_draws(key) -> tuple[ObjDraws, dict]:
    """The JAX stage-3 step's draws (steps.py:286-314, the biased sampler of
    diffusion/scheduler.py:79-84, the adapter-input dropout of
    utils/traj_features.py:82), with the sampler's branch draws."""
    c = OBJ_CFG

    @jax.jit
    def draw(key):
        r = jax.random.split(key, 8)
        lat = (B, F, H // 8, W // 8, 4)
        r1, r2, r3 = jax.random.split(r[5], 3)
        high = jax.random.randint(r1, (B,), c["omcm_min_step"], 1000)
        low = jax.random.randint(r2, (B,), 0, c["omcm_min_step"])
        take_high = jax.random.uniform(r3, (B,)) < c["min_step_prob"]
        return {"use_background": jax.random.uniform(r[0]) < c["background_caption_prob"],
                "text_drop": jax.random.uniform(r[1], (B,)) < c["cfg_random_null_text_ratio"],
                "camera_drop": jax.random.uniform(r[2], (B,)) < c["cfg_random_null_text_ratio"],
                "vae_eps": jax.random.normal(r[3], (B * F, *lat[2:]), jnp.float32),
                "noise": jax.random.normal(r[4], lat, jnp.float32),
                "timesteps": jnp.where(take_high, high, low),
                "om_uniform": jax.random.uniform(r[6], (B,)),
                "anchor": jax.random.randint(r[7], (B,), 0, F)}, take_high

    values, take_high = draw(key)
    return (ObjDraws(**{k: torch.from_numpy(np.array(v)) for k, v in values.items()}),
            {"take_high": np.asarray(take_high)})


def _named(tree: dict, kinds) -> dict:
    return {f"{kind}.{k}": v for kind in kinds if kind in tree
            for k, v in jax_state_dict(tree[kind], kind).items()}


def _check_grads(grads: dict, want: dict) -> None:
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=1e-3,
                                   err_msg=name)


def _check_metrics(metrics: dict, want: dict) -> None:
    assert set(metrics) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, err_msg=k)


def _jax_grads(grads_fn, trainable, frozen, batch, key):
    """The grads function as one program compiled at backend level 0."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    compiled = jax.jit(grads_fn).lower(trainable, frozen, jbatch, key).compile(
        compiler_options=COMPILE)
    grads, metrics = compiled(trainable, frozen, jbatch, key)
    return (jax.tree_util.tree_map(np.asarray, grads),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def lora_case():
    cfg = two_level_config()
    models, params = jax_params(cfg, "lora", 1)
    t_unet, f_unet = jax_partition(params["unet"], jax_stage1)
    frozen = {"unet": f_unet, "vae": {"params": params["vae"]},
              "text": {"params": params["clip_text"]}}
    schedule = JSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    grads_fn = jax_lora_grads_fn(models["unet"], models["vae"], models["text"], schedule,
                                 JStepConfig(**LORA_CFG))
    key = jax.random.PRNGKey(LORA_KEY)
    batch = _batch("lora")
    grads, metrics = _jax_grads(grads_fn, {"unet": t_unet}, frozen, batch, key)
    return dict(cfg=cfg, params=params, batch=batch, draws=_lora_draws(key), grads=grads,
                metrics=metrics)


@pytest.fixture(scope="module")
def obj_case():
    cfg = two_level_config()
    models, params = jax_params(cfg, "obj", F)
    t_unet, f_unet = jax_partition(params["unet"], lambda p: jax_stage3(p, train_cm=True))
    trainable = {"adapter": params["adapter"], "unet": t_unet,
                 "pose_encoder": params["pose_encoder"]}
    frozen = {"unet": f_unet, "vae": {"params": params["vae"]},
              "text": {"params": params["clip_text"]}}
    schedule = JSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    grads_fn = jax_obj_grads_fn(models["unet"], models["pose_encoder"], models["adapter"],
                                models["vae"], models["text"], schedule, JStepConfig(**OBJ_CFG))
    key = jax.random.PRNGKey(OBJ_KEY)
    batch = _batch("obj")
    grads, metrics = _jax_grads(grads_fn, trainable, frozen, batch, key)
    draws, branches = _obj_draws(key)
    return dict(cfg=cfg, params=params, batch=batch, draws=draws, branches=branches,
                grads=grads, metrics=metrics)


def test_draws_cover_the_branches(lora_case, obj_case):
    assert lora_case["draws"].text_drop.tolist() == [False, True]
    d = obj_case["draws"]
    assert bool(d.use_background) and d.text_drop.tolist() == [False, True]
    assert obj_case["branches"]["take_high"].tolist() == [False, True]
    assert d.timesteps[0] < 700 <= d.timesteps[1]
    assert (d.om_uniform > OBJ_CFG["cfg_random_null_om_ratio"]).tolist() == [False, True]


def test_lora_grads_match_jax(lora_case):
    models = port_models(lora_case["cfg"], "lora", lora_case["params"])
    trainable = partition_params(models["unet"], stage1_lora_trainable, "unet.")
    for name in ("vae", "text"):
        partition_params(models[name], lambda n: False)
    schedule = DiffusionSchedule.from_config(**lora_case["cfg"]["noise_scheduler_kwargs"])
    grads_fn = make_lora_grads_fn(models["unet"], models["vae"], models["text"], schedule,
                                  StepConfig(**LORA_CFG))
    grads, metrics = grads_fn(trainable, _torch_batch(lora_case["batch"]), lora_case["draws"])
    _check_metrics(metrics, lora_case["metrics"])
    assert trainable and all("lora" in n for n in trainable)
    _check_grads(grads, _named(lora_case["grads"], ("unet",)))


@pytest.mark.parametrize("pose", ["trainable", "frozen"])
def test_obj_grads_match_jax(obj_case, pose):
    """The JAX program trains the pose encoder and the merges (train_cm); a
    frozen pose encoder leaves the adapter's gradients as they are."""
    models = port_models(obj_case["cfg"], "obj", obj_case["params"])
    train_cm = pose == "trainable"
    trainable = {
        **partition_params(models["unet"], lambda n: stage3_unet_trainable(n, train_cm=train_cm),
                           "unet."),
        **partition_params(models["adapter"], lambda n: True, "adapter."),
        **partition_params(models["pose_encoder"], lambda n: train_cm, "pose_encoder.")}
    for name in ("vae", "text"):
        partition_params(models[name], lambda n: False)
    schedule = DiffusionSchedule.from_config(**obj_case["cfg"]["noise_scheduler_kwargs"])
    grads_fn = make_obj_grads_fn(models["unet"], models["pose_encoder"], models["adapter"],
                                 models["vae"], models["text"], schedule, StepConfig(**OBJ_CFG))
    grads, metrics = grads_fn(trainable, _torch_batch(obj_case["batch"]), obj_case["draws"])
    _check_metrics(metrics, obj_case["metrics"])
    want = _named(obj_case["grads"], ("unet", "pose_encoder", "adapter"))
    if not train_cm:
        want = {n: v for n, v in want.items() if n.startswith("adapter.")}
        assert all(p.grad is None for p in models["pose_encoder"].parameters())
    _check_grads(grads, want)
    # the 4th down block takes no traj feature: the adapter's last stage has
    # a zero gradient in both packages
    zero = [n for n, g in grads.items() if not g.abs().max() > 0]
    assert zero and all(n.startswith("adapter.") for n in zero)
    assert all(not np.abs(want[n]).max() > 0 for n in zero)


@pytest.mark.parametrize("stage", ["lora", "obj"])
def test_stage_partitions_match_jax(stage):
    """The JAX package's path rules and the port's name rules pick the same
    tensors: stage 1's LoRA, and stage 3's subsets under each flag."""
    cfg = two_level_config()
    _, params = jax_params(cfg, stage, 1 if stage == "lora" else F)
    flat = flatten_dict(params["unet"])
    unet = build_models(cfg, stage)["unet"]
    if stage == "lora":
        rules = [(jax_stage1, stage1_lora_trainable)]
    else:
        flags = [dict(train_cm=True), dict(train_mm=True), dict(train_image_lora=True),
                 dict(train_cm=True, train_mm=True, train_image_lora=True)]
        rules = [((lambda p, f=f: jax_stage3(p, **f)),
                  (lambda n, f=f: stage3_unet_trainable(n, **f))) for f in flags]
    for jrule, rule in rules:
        want = {unet_path_to_torch(k) for k in flat if jrule("/".join(k))}
        got = set(partition_params(unet, rule))
        assert got == want and got
    assert not partition_params(unet, lambda n: stage3_unet_trainable(n))


@pytest.mark.parametrize("stage", ["lora", "cam", "obj"])
def test_stage_models_match_jax_names_and_counts(stage):
    """build_models per stage: the same modules, parameter names and sizes as
    the JAX package's (lora: no motion modules, no pose merges, no pose
    encoder; obj: the adapter)."""
    cfg = two_level_config()
    _, params = jax_params(cfg, stage, 1 if stage == "lora" else F)
    models = build_models(cfg, stage)
    kinds = {"lora": {"unet", "vae", "text"}, "cam": {"unet", "vae", "text", "pose_encoder"},
             "obj": {"unet", "vae", "text", "pose_encoder", "adapter"}}[stage]
    assert set(models) == kinds
    for name, module in models.items():
        kind = "clip_text" if name == "text" else name
        want = {k: int(np.prod(v.shape)) for k, v in jax_state_dict(params[kind], kind).items()}
        got = {k: p.numel() for k, p in module.named_parameters()}
        assert got == want, f"{name}: {sorted(set(got) ^ set(want))[:5]}"
    unet_names = [n for n, _ in models["unet"].named_parameters()]
    assert any("motion_modules" in n for n in unet_names) == (stage != "lora")
    assert any("_merge." in n for n in unet_names) == (stage != "lora")


def test_sample_timesteps_biased_matches_jax():
    """Both samplers are where(u < p, high, low) over their three draws in
    the same order: high in [min_step, T), low in [0, min_step), then u."""
    n, min_step, p = 4096, 700, 0.8
    key = jax.random.PRNGKey(3)
    got_j = np.asarray(JSchedule.from_config().sample_timesteps_biased(key, n, min_step, p))
    r1, r2, r3 = jax.random.split(key, 3)
    want_j = np.where(np.asarray(jax.random.uniform(r3, (n,))) < p,
                      np.asarray(jax.random.randint(r1, (n,), min_step, 1000)),
                      np.asarray(jax.random.randint(r2, (n,), 0, min_step)))
    np.testing.assert_array_equal(got_j, want_j)
    gen = torch.Generator().manual_seed(3)
    got = DiffusionSchedule.from_config().sample_timesteps_biased(gen, n, min_step, p)
    gen.manual_seed(3)
    high = torch.randint(min_step, 1000, (n,), generator=gen)
    low = torch.randint(0, min_step, (n,), generator=gen)
    want = torch.where(torch.rand((n,), generator=gen) < p, high, low)
    assert torch.equal(got, want)
    for t in (got.numpy(), got_j):
        assert t.min() >= 0 and t.max() < 1000
        assert abs((t >= min_step).mean() - (p + (1 - p) * 0)) < 0.03


@pytest.fixture(scope="module")
def lora_dataset_params(tmp_path_factory):
    root = tmp_path_factory.mktemp("synfmc_lora_data")
    kw = build_synthetic_dataset(str(root), num_seqs=2, num_objects=2, num_frames=48)
    return dict(kw, sample_size=[32, 48])


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_lora_dataset_items_match_jax(lora_dataset_params, flip, seed):
    params = dict(lora_dataset_params, use_flip=flip)
    port, ref = UnrealTrajLoraDataset(**params, seed=seed), JLoraDataset(**params, seed=seed)
    assert len(port) == len(ref) == 2
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        items = [(port[idx], ref[idx]) for idx in (1, 0)]
        for got, want in items:
            assert got["pixel_values"].shape == (32, 48, 3) and got["caption"]
            assert_same_item(got, want)
        assert_same_item(UnrealTrajLoraDataset.collate_fn([g for g, _ in items]),
                         JLoraDataset.collate_fn([w for _, w in items]))


def test_lora_loader_order_matches_jax(lora_dataset_params):
    ref = JLoader(JLoraDataset(**lora_dataset_params, seed=3), batch_size=2,
                  collate_fn=JLoraDataset.collate_fn, seed=5, num_workers=0, process_index=0,
                  process_count=1)
    want = [b for _, b in zip(range(3), ref.epochs(start_epoch=1))]
    port = ShardedLoader(UnrealTrajLoraDataset(**copy.deepcopy(lora_dataset_params), seed=3),
                         batch_size=2, collate_fn=UnrealTrajLoraDataset.collate_fn, seed=5,
                         num_workers=2)
    try:
        got = [b for _, b in zip(range(3), port.epochs(start_epoch=1))]
    finally:
        port.close()
    assert [e for e, _ in got] == [e for e, _ in want] == [1, 2, 3]
    for (_, g), (_, w) in zip(got, want):
        assert_same_item(g, w)
