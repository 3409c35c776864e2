"""The port's trainer modes and its three-stage trainer, on the CPU.

- gradient accumulation: the port's accumulating step over 2 micro-batches
  against synfmc_tpu/training/steps.py:make_accumulating_step on stage 1
  (the two-level config of tests/test_torch_stages.py; micro i's draws from
  ``fold_in(key, i)``), its mean gradients (read through an optimizer that
  records them) and metrics within the tolerances of tests/test_torch_train.py;
- rematerialisation: "full" and "dots" give the plain step's gradients bit
  for bit (fp32 on the CPU runs the same ops in the same order), draw no
  random numbers, and recompute what their policy says (counted at dispatch);
- validation renders: the port's ``run_validation`` writes the JAX
  package's set of files for stages lora, cam and obj and the prompt-driven
  fallback, its text files equal to 1e-5 and its mask PNGs pixel for pixel
  (the JAX side's sampler replaced by a stand-in: the renders' pixels come
  from different random streams and are not compared);
- the trainer at tiny width (tests/test_trainers.py's overrides, fp32, 64x64,
  2 frames) on a fixture of 2 sequences: stages lora and obj run, resume
  exactly and, for obj, warm-start the step count from an OMC bundle; the
  bundles load into the JAX package and equal the port's weights, their
  optimizer state keyed as the JAX trainer keys it; accumulation resumes
  exactly; the epoch arithmetic; the profiler window's trace; the script.
"""

import copy
import glob
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from torch.utils._python_dispatch import TorchDispatchMode

from synfmc_tpu.config import ConfigDict
from synfmc_tpu.data.dataset import UnrealTrajVideoDataset as JDataset
from synfmc_tpu.diffusion import DiffusionSchedule as JSchedule
from synfmc_tpu.training import checkpoint as jckpt
from synfmc_tpu.training import trainers as jtrainers
from synfmc_tpu.training.params import partition_params as jax_partition
from synfmc_tpu.training.params import stage1_lora_trainable as jax_stage1
from synfmc_tpu.training.params import stage3_unet_trainable as jax_stage3
from synfmc_tpu.training.steps import StepConfig as JStepConfig
from synfmc_tpu.training.steps import init_train_state as jax_init_state
from synfmc_tpu.training.steps import make_accumulating_step as jax_accumulating_step
from synfmc_tpu.training.steps import make_lora_grads_fn as jax_lora_grads_fn
from synfmc_tpu_torch.config import load_config
from synfmc_tpu_torch.data.dataset import UnrealTrajVideoDataset
from synfmc_tpu_torch.data.fixture import build_synthetic_dataset
from synfmc_tpu_torch.data.tokenizer import HashTokenizer
from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
from synfmc_tpu_torch.interop.torch_port import jax_state_dict
from synfmc_tpu_torch.pipelines.factory import init_models
from synfmc_tpu_torch.scripts import train as train_script
from synfmc_tpu_torch.training import checkpoint as ckpt
from synfmc_tpu_torch.training.params import partition_params, stage1_lora_trainable
from synfmc_tpu_torch.training.steps import (
    StepConfig,
    TrainState,
    draw_obj,
    make_accumulating_step,
    make_lora_grads_fn,
    make_obj_grads_fn,
)
from synfmc_tpu_torch.training.trainers import (
    epoch_boundary,
    epoch_steps,
    host_batch,
    object_batch,
    step_config,
    train,
)
from synfmc_tpu_torch.training.validation import run_validation
from tests.test_torch_modules import randomize, shapes
from tests.test_torch_stages import (
    B,
    LORA_CFG,
    _check_grads,
    _check_metrics,
    _lora_draws,
    _named,
    _torch_batch,
    jax_params,
    port_models,
)
from tests.test_torch_train import two_level_config
from tests.test_trainers import TINY_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, W = 2, 64, 64
ACCUM = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Bit-for-bit comparisons need one intra-op thread: with several, the
    CPU's GEMM may split a weight gradient's reduction differently from one
    call to the next (the LoRA gradients of one step differ by ~3e-8 between
    two calls on the same inputs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# gradient accumulation against the JAX package's
# ---------------------------------------------------------------------------


def _capture_tx():
    """An optax transformation whose state after an update is the gradient
    it was given (the parameters stay)."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(init=zeros,
                                        update=lambda g, s, p=None: (zeros(g), g))


class _Capture:
    """The port's counterpart: an optimizer that records the gradients."""

    def __init__(self, params):
        self.params, self.count, self.grads = list(params), 0, None

    def step(self, grads):
        self.grads, self.count = list(grads), self.count + 1


def _micro_batches():
    rng = np.random.default_rng(5)
    tok = HashTokenizer()
    caps = [["a knight marches across a field", "a blue dragon soars"],
            ["a yellow bird hops along the road", "a red car on a coast road"]]
    return [{"pixel_values": rng.uniform(-1, 1, (B, 128, 128, 3)).astype(np.float32),
             "input_ids": tok(c), "null_ids": tok([""])[0]} for c in caps]


@pytest.fixture(scope="module")
def accum_case():
    cfg = two_level_config()
    models, params = jax_params(cfg, "lora", 1)
    t_unet, f_unet = jax_partition(params["unet"], jax_stage1)
    frozen = {"unet": f_unet, "vae": {"params": params["vae"]},
              "text": {"params": params["clip_text"]}}
    schedule = JSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    grads_fn = jax_lora_grads_fn(models["unet"], models["vae"], models["text"], schedule,
                                 JStepConfig(**LORA_CFG))
    tx = _capture_tx()
    step = jax_accumulating_step(grads_fn, tx, ACCUM)
    micro = _micro_batches()
    stacked = {k: jnp.asarray(np.stack([m[k] for m in micro])) for k in micro[0]}
    key = jax.random.PRNGKey(4)
    state = jax_init_state({"unet": t_unet}, tx)
    compiled = jax.jit(step).lower(state, frozen, stacked, key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    new_state, metrics = compiled(state, frozen, stacked, key)
    return dict(cfg=cfg, params=params, micro=micro,
                draws=[_lora_draws(jax.random.fold_in(key, i)) for i in range(ACCUM)],
                grads=jax.tree_util.tree_map(np.asarray, new_state.opt_state),
                metrics={k: float(v) for k, v in metrics.items()})


def test_accumulating_step_matches_jax(accum_case):
    models = port_models(accum_case["cfg"], "lora", accum_case["params"])
    trainable = partition_params(models["unet"], stage1_lora_trainable, "unet.")
    for name in ("vae", "text"):
        partition_params(models[name], lambda n: False)
    schedule = DiffusionSchedule.from_config(**accum_case["cfg"]["noise_scheduler_kwargs"])
    grads_fn = make_lora_grads_fn(models["unet"], models["vae"], models["text"], schedule,
                                  StepConfig(**LORA_CFG))
    state = TrainState(step=0, trainable=trainable, masters=trainable,
                       optimizer=_Capture(trainable.values()))
    step = make_accumulating_step(grads_fn, ACCUM)
    state, metrics = step(state, [_torch_batch(m) for m in accum_case["micro"]],
                          accum_case["draws"])
    assert state.step == 1 and state.optimizer.count == 1
    _check_metrics(metrics, accum_case["metrics"])
    grads = dict(zip(trainable, state.optimizer.grads))
    _check_grads(grads, _named(accum_case["grads"], ("unet",)))
    assert all(p.grad is None for p in trainable.values())  # nothing kept past the step
    with pytest.raises(ValueError, match="micro-batches"):
        step(state, [_torch_batch(accum_case["micro"][0])], accum_case["draws"][:1])


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def tiny_config(stage, fixture_kwargs, output_dir, **extra) -> dict:
    cfg = load_config(os.path.join(REPO, "configs", f"{stage}.yaml"))
    cfg.update(output_dir=str(output_dir), model_overrides=copy.deepcopy(TINY_OVERRIDES),
               train_batch_size=2 if stage == "lora" else 1, checkpointing_steps=2,
               logger_interval=1, num_workers=2, mixed_precision_training=False,
               record_loss_history=True, do_sanity_check=False)
    params = dict(fixture_kwargs, sample_size=[H, W])
    if stage != "lora":
        params.update(sample_n_frames=F, max_objects=2)
    cfg["train_data"]["params"].update(params)
    if stage == "obj":
        cfg["allow_untrained_cm"] = True
    cfg.update(extra)
    return cfg


@pytest.fixture(scope="module")
def fixture_kwargs(tmp_path_factory):
    root = tmp_path_factory.mktemp("synfmc_stages")
    return build_synthetic_dataset(str(root), num_seqs=2, num_objects=2, num_frames=48)


@pytest.fixture(scope="module")
def obj_batch(fixture_kwargs, tmp_path_factory):
    cfg = tiny_config("obj", fixture_kwargs, tmp_path_factory.mktemp("unused"))
    ds = UnrealTrajVideoDataset(**cfg["train_data"]["params"], seed=1)
    raw = UnrealTrajVideoDataset.collate_fn([ds[0]])
    batch = host_batch(raw, HashTokenizer(), "cpu")
    batch.update(object_batch(raw, "cpu"))
    return cfg, batch


def _obj_grads(cfg, batch, remat, policy="full"):
    models = init_models(cfg, "obj", 3, "cpu")
    trainable = {**partition_params(models["adapter"], lambda n: True, "adapter."),
                 **partition_params(models["unet"], lambda n: "_merge." in n, "unet.")}
    for name in ("vae", "text", "pose_encoder"):
        partition_params(models[name], lambda n: False)
    scfg = step_config(dict(cfg, gradient_checkpointing=remat,
                            gradient_checkpointing_policy=policy), "obj")
    schedule = DiffusionSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    draws = draw_obj(torch.Generator().manual_seed(9), batch, scfg, schedule)
    grads_fn = make_obj_grads_fn(models["unet"], models["pose_encoder"], models["adapter"],
                                 models["vae"], models["text"], schedule, scfg)
    rng = torch.random.get_rng_state()
    with _OpCounter() as ops:
        grads, metrics = grads_fn(trainable, batch, draws)
    assert torch.equal(rng, torch.random.get_rng_state())  # no draw in the recompute
    return {n: g.clone() for n, g in grads.items()}, metrics, ops.ops


@pytest.fixture(scope="module")
def plain_obj_grads(obj_batch):
    return _obj_grads(*obj_batch, remat=False)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_plain_gradients(obj_batch, plain_obj_grads, policy):
    grads, metrics, ops = _obj_grads(*obj_batch, remat=True, policy=policy)
    want, want_metrics, plain_ops = plain_obj_grads
    assert metrics.keys() == want_metrics.keys()
    assert all(torch.equal(metrics[k], want_metrics[k]) for k in metrics)
    assert grads.keys() == want.keys()
    bad = [n for n in grads if not torch.equal(grads[n], want[n])]
    assert not bad, f"{len(bad)} gradients differ, e.g. {bad[:3]}"
    # what the policy recomputes: every product and conv ("full"), or all
    # but the Dense products, whose outputs it saves ("dots")
    mm = lambda o: o.get("mm", 0) + o.get("addmm", 0)
    assert ops["convolution"] > plain_ops["convolution"]
    assert ops.get("bmm", 0) > plain_ops.get("bmm", 0)
    assert (mm(ops) > mm(plain_ops)) == (policy == "full")
    if policy == "dots":
        assert mm(ops) == mm(plain_ops)


def test_unknown_remat_policy_raises(obj_batch):
    with pytest.raises(ValueError, match="remat_policy"):
        _obj_grads(*obj_batch, remat=True, policy="offload")


# ---------------------------------------------------------------------------
# validation renders
# ---------------------------------------------------------------------------


class _StandInPipe:
    """The JAX sampler replaced: zeros of the rendered shape."""

    adapter = object()

    def __call__(self, prompts, video_length=16, height=256, width=384, **_):
        return np.zeros((len(prompts), video_length, height, width, 3), np.float32)

    def encode_traj(self, feats, mask, f):
        return None


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _numbers(path):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e[-+]?\d+)?", open(path).read())]


VALIDATION = {"lora": ("lora", True), "cam": ("cam", True), "obj": ("obj", True),
              "cam_prompts": ("cam", False)}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_writes_the_jax_files(case, fixture_kwargs, tmp_path, monkeypatch):
    stage, use_dataset = VALIDATION[case]
    cfg = tiny_config(stage, fixture_kwargs, tmp_path)
    cfg["validation_data"] = dict(cfg["validation_data"], num_inference_steps=2, num=2,
                                  use_dataset=use_dataset)
    params = cfg["train_data"]["params"]
    port_ds = None if stage == "lora" else UnrealTrajVideoDataset(**params, seed=4)
    models = init_models(cfg, stage, 0, "cpu")
    got = run_validation(stage, str(tmp_path / "port"), 3, models, cfg, HashTokenizer(),
                         DiffusionSchedule.from_config(**cfg["noise_scheduler_kwargs"]),
                         dataset=port_ds, device="cpu")
    monkeypatch.setattr(jtrainers, "build_validation_pipeline", lambda *a, **k: _StandInPipe())
    jax_ds = None if stage == "lora" else JDataset(**params, seed=4)
    jtrainers.run_validation(stage, str(tmp_path / "jax"), 3,
                             {"pose_encoder": None} if stage != "lora" else {}, None, None,
                             ConfigDict(cfg), None, None, dataset=jax_ds)
    port_dir, jax_dir = tmp_path / "port" / "samples" / "3", tmp_path / "jax" / "samples" / "3"
    want = _files(jax_dir)
    assert got == _files(port_dir) == want and want
    for name in want:
        a, b = port_dir / name, jax_dir / name
        if name.endswith(".txt"):
            assert open(a).read().splitlines()[0] == open(b).read().splitlines()[0]
            np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        elif "masks" in name:
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        else:  # renders: the same size and mode
            with Image.open(a) as x, Image.open(b) as y:
                assert (x.size, x.mode == "P" or x.mode) == (y.size, y.mode == "P" or y.mode)
    if stage == "obj":
        assert any(n.startswith("0_real_masks/") for n in want)


def test_validation_keeps_the_modules_training_flags(fixture_kwargs, tmp_path):
    cfg = tiny_config("lora", fixture_kwargs, tmp_path)
    cfg["validation_data"] = dict(cfg["validation_data"], num_inference_steps=1, num=1)
    models = init_models(cfg, "lora", 0, "cpu")
    models["vae"].eval()
    flags = {m: m.training for module in models.values() for m in module.modules()}
    assert any(flags.values()) and not all(flags.values())
    files = run_validation("lora", str(tmp_path), 1, models, cfg, HashTokenizer(),
                           DiffusionSchedule.from_config(), device="cpu")
    assert files == ["validation.png"]
    assert flags == {m: m.training for module in models.values() for m in module.modules()}


# ---------------------------------------------------------------------------
# the three-stage trainer
# ---------------------------------------------------------------------------


def native(run_dir: str, step: int) -> dict:
    return ckpt.restore_native(os.path.join(run_dir, "checkpoints", f"step-{step}"))


def assert_same_state(a: dict, b: dict) -> None:
    assert (a["step"], a["epoch"], a["count"]) == (b["step"], b["epoch"], b["count"])
    for key in ("masters", "exp_avg", "exp_avg_sq"):
        assert a[key].keys() == b[key].keys()
        bad = [n for n in a[key] if not torch.equal(a[key][n], b[key][n])]
        assert not bad, f"{key}: {len(bad)} tensors differ, e.g. {bad[:3]}"


OBJ_FLAGS = dict(train_cm=True, train_mm=True, train_image_lora=True)


@pytest.fixture(scope="module")
def runs(fixture_kwargs, tmp_path_factory):
    """Per stage: 4 steps uninterrupted (a), 2 steps (b) then resume_from:
    auto to 4 (c); obj with every trainable set.  Then an obj warm start
    from run a's omcm-step-2.ckpt to step 3."""
    root = tmp_path_factory.mktemp("stage_runs")
    out = {}
    for stage, extra in (("lora", {}), ("obj", OBJ_FLAGS)):
        cfg = lambda d, **kw: tiny_config(stage, fixture_kwargs, root / stage / d, **extra, **kw)
        out[stage] = {"a": train(stage, cfg("a"), max_steps=4, device="cpu"),
                      "b": train(stage, cfg("b"), max_steps=2, device="cpu")}
        out[stage]["c"] = train(stage, cfg("b", resume_from="auto"), max_steps=4, device="cpu")
    warm = tiny_config("obj", fixture_kwargs, root / "warm", **OBJ_FLAGS)
    warm["omcm_config"]["pretrained"] = os.path.join(out["obj"]["a"]["run_dir"], "checkpoints",
                                                     "omcm-step-2.ckpt")
    out["warm"] = train("obj", warm, max_steps=3, device="cpu")
    return out


@pytest.mark.parametrize("stage", ["lora", "obj"])
def test_stage_resume_is_exact(runs, stage):
    a, b, c = runs[stage]["a"], runs[stage]["b"], runs[stage]["c"]
    assert a["steps"] == c["steps"] == 4 and b["steps"] == 2
    assert np.isfinite(a["loss_history"]).all() and len(c["loss_history"]) == 2
    np.testing.assert_array_equal(a["loss_history"][2:], c["loss_history"])
    np.testing.assert_array_equal(a["loss_history"][:2], b["loss_history"])
    assert_same_state(native(a["run_dir"], 2), native(b["run_dir"], 2))
    assert_same_state(native(a["run_dir"], 4), native(c["run_dir"], 4))
    t0, t1 = a["checksums"]["trainable"]
    f0, f1 = a["checksums"]["frozen"]
    assert t0 != t1 and f0 == f1


def test_obj_warm_start_resumes_the_step_count(runs):
    """omcm_config.pretrained: the adapter from the bundle and its step count
    (2), not its optimizer state; step 3's draws are run a's step 3's."""
    warm, a = runs["warm"], runs["obj"]["a"]
    assert warm["steps"] == 3 and len(warm["loss_history"]) == 1
    state = native(warm["run_dir"], 3)
    assert state["step"] == 3 and state["count"] == 1
    saved = native(a["run_dir"], 2)["masters"]
    bundle = ckpt.torch_load_state_dict(os.path.join(a["run_dir"], "checkpoints",
                                                     "omcm-step-2.ckpt"))
    assert all(torch.equal(v, saved["adapter." + k]) for k, v in
               bundle["omcm_state_dict"].items())
    assert np.isfinite(warm["loss_history"]).all()


def _jax_unet_template(cfg, stage):
    """The JAX package's UNet, pose encoder and adapter param trees at the
    tiny widths (seeded values; shapes from the traced init)."""
    models = jtrainers.build_models(ConfigDict(cfg), stage)
    chs = TINY_OVERRIDES["block_out_channels"]
    key = jax.random.PRNGKey(0)
    f = 1 if stage == "lora" else F
    pose = ([jnp.zeros((1, f, H // 8 // 2**i, W // 8 // 2**i, c)) for i, c in enumerate(chs)]
            if stage != "lora" else None)
    out = {"unet": shapes(models["unet"], key, jnp.zeros((1, f, H // 8, W // 8, 4)),
                          jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 77, TINY_OVERRIDES["cross_attention_dim"])),
                          pose_features=pose)}
    if stage == "obj":
        out["pose_encoder"] = shapes(models["pose_encoder"], key, jnp.zeros((1, f, H, W, 6)))
        out["adapter"] = shapes(models["adapter"], key, jnp.zeros((f, H, W, 13)),
                                jnp.zeros((f, H, W, 1)))
    return {k: randomize(v, seed=i + 1)["params"] for i, (k, v) in enumerate(out.items())}


def _check_optimizer_export(stage, bundle_opt, saved, cfg, trainable):
    jstate = SimpleNamespace(opt_state=SimpleNamespace(count=np.int32(saved["count"]),
                                                       mu=trainable, nu=trainable))
    want = jtrainers._export_optimizer_state(stage, jstate, ConfigDict(cfg))
    assert bundle_opt["param_names"] == want["param_names"]
    assert bundle_opt["param_groups"] == want["param_groups"]
    for i in range(len(want["param_names"])):
        assert bundle_opt["state"][i]["exp_avg"].shape == want["state"][i]["exp_avg"].shape


def test_stage1_bundle_loads_into_jax(runs, fixture_kwargs, tmp_path):
    a = runs["lora"]["a"]
    bundle = jckpt.torch_load_state_dict(os.path.join(a["run_dir"], "checkpoints",
                                                      "lora-step-4.ckpt"))
    saved = native(a["run_dir"], 4)
    assert (bundle["epoch"], bundle["global_step"]) == (saved["epoch"], 4)
    cfg = tiny_config("lora", fixture_kwargs, tmp_path)
    template = _jax_unet_template(cfg, "lora")
    unet = jckpt.load_into_params(template["unet"], bundle["lora_state_dict"], "unet")
    got = {"unet." + k: v for k, v in jax_state_dict(unet, "unet").items() if "lora" in k}
    assert got.keys() == saved["masters"].keys() and got
    bad = [n for n, v in got.items() if not np.array_equal(v, saved["masters"][n].numpy())]
    assert not bad, f"{len(bad)} tensors differ after the JAX package's load, e.g. {bad[:3]}"
    t_unet, _ = jax_partition(template["unet"], jax_stage1)
    _check_optimizer_export("lora", bundle["optimizer_state_dict"], saved, cfg,
                            {"unet": t_unet})


def test_stage3_bundles_load_into_jax(runs, fixture_kwargs, tmp_path):
    """omcm (adapter, optimizer state, train_mm's tensors), cmcm (pose
    encoder and the merges alone) and img-lora (the LoRA), as
    tests/test_trainers.py:test_obj_bundle_partition partitions them."""
    a = runs["obj"]["a"]
    ck = os.path.join(a["run_dir"], "checkpoints")
    saved = native(a["run_dir"], 4)
    masters = saved["masters"]
    load = lambda name: jckpt.torch_load_state_dict(os.path.join(ck, f"{name}-step-4.ckpt"))
    omcm, cmcm, lora = load("omcm"), load("cmcm"), load("img-lora")
    cfg = tiny_config("obj", fixture_kwargs, tmp_path, **OBJ_FLAGS)
    template = _jax_unet_template(cfg, "obj")
    got = {}
    adapter = jckpt.load_into_params(template["adapter"], omcm["omcm_state_dict"], "adapter")
    got.update({"adapter." + k: v for k, v in jax_state_dict(adapter, "adapter").items()})
    pose = jckpt.load_into_params(template["pose_encoder"], cmcm["pose_encoder_state_dict"],
                                  "pose_encoder")
    got.update({"pose_encoder." + k: v
                for k, v in jax_state_dict(pose, "pose_encoder").items()})
    unet = template["unet"]
    for sd in (cmcm["attention_processor_state_dict"], lora["lora_state_dict"],
               omcm["mm_state_dict"]):
        unet = jckpt.load_into_params(unet, sd, "unet")
    keys = {*cmcm["attention_processor_state_dict"], *lora["lora_state_dict"],
            *omcm["mm_state_dict"]}
    got.update({"unet." + k: v for k, v in jax_state_dict(unet, "unet").items() if k in keys})
    assert got.keys() == masters.keys()
    bad = [n for n, v in got.items() if not np.array_equal(v, masters[n].numpy())]
    assert not bad, f"{len(bad)} tensors differ after the JAX package's load, e.g. {bad[:3]}"
    assert all("merge" in k and "lora" not in k for k in cmcm["attention_processor_state_dict"])
    assert all("lora" in k for k in lora["lora_state_dict"])
    assert all("merge" not in k and "lora" not in k for k in omcm["mm_state_dict"])
    assert cmcm["global_step"] == lora["global_step"] == omcm["global_step"] == 4
    t_unet, _ = jax_partition(template["unet"], lambda p: jax_stage3(p, **OBJ_FLAGS))
    _check_optimizer_export("obj", omcm["optimizer_state_dict"], saved, cfg,
                            {"adapter": template["adapter"], "unet": t_unet,
                             "pose_encoder": template["pose_encoder"]})


def test_default_obj_stage_writes_the_reference_layout(fixture_kwargs, tmp_path):
    """No train_cm / train_mm / train_image_lora: the adapter alone trains,
    the pose encoder is frozen, and only omcm-step-N.ckpt is written, with no
    mm_state_dict."""
    m = train("obj", tiny_config("obj", fixture_kwargs, tmp_path), max_steps=1, device="cpu")
    ck = os.path.join(m["run_dir"], "checkpoints")
    assert sorted(os.listdir(ck)) == ["omcm-step-1.ckpt", "step-1"]
    assert "mm_state_dict" not in ckpt.torch_load_state_dict(os.path.join(ck,
                                                                          "omcm-step-1.ckpt"))
    assert all(n.startswith("adapter.") for n in native(m["run_dir"], 1)["masters"])


def test_accumulation_resumes_exactly(fixture_kwargs, tmp_path):
    """gradient_accumulation_steps 2 with remat: 2 loader batches a step; a
    run stopped at 2 and resumed to 3 takes the same batches and draws."""
    cfg = lambda d, **kw: tiny_config("lora", fixture_kwargs, tmp_path / d, train_batch_size=1,
                                      gradient_accumulation_steps=2, gradient_checkpointing=True,
                                      **kw)
    a = train("lora", cfg("a"), max_steps=3, device="cpu")
    train("lora", cfg("b"), max_steps=2, device="cpu")
    c = train("lora", cfg("b", resume_from="auto"), max_steps=3, device="cpu")
    assert a["steps"] == c["steps"] == 3 and len(c["loss_history"]) == 1
    np.testing.assert_array_equal(a["loss_history"][2:], c["loss_history"])
    assert_same_state(native(a["run_dir"], 3), native(c["run_dir"], 3))
    assert native(a["run_dir"], 3)["epoch"] == 2  # 2 batches an epoch, 2 a step


@pytest.mark.parametrize("batches,accum,epochs", [(4, 2, 3), (6, 3, 2), (5, 1, 2), (5, 2, 2),
                                                   (3, 2, 3)])
def test_epoch_arithmetic(batches, accum, epochs):
    """Run length ceil(N * len / k) and checkpoints at the steps that complete
    N epochs of batches; where k divides len both equal the JAX trainer's
    N * ceil(len / k) and its step cadence (trainers.py:415, :564)."""
    steps = epoch_steps(epochs, batches, accum)
    assert steps == -(-epochs * batches // accum)
    every = [s for s in range(1, 4 * steps + 1) if epoch_boundary(s, 1, batches, accum)]
    assert all(((s * accum) // batches) - (((s - 1) * accum) // batches) == 1 for s in every)
    jax_steps = epochs * -(-batches // accum)
    if batches % accum == 0:
        assert steps == jax_steps
        assert every == list(range(batches // accum, 4 * steps + 1, batches // accum))
    else:  # the JAX trainer rounds each epoch up; the port the whole run
        assert steps < jax_steps


def test_epoch_denominated_run_length(fixture_kwargs, tmp_path):
    """max_train_steps -1: max_train_epoch 1 of 2 batches at accumulation 2
    is one step, and its checkpoint lands on the epoch's last batch."""
    cfg = tiny_config("lora", fixture_kwargs, tmp_path, train_batch_size=1,
                      gradient_accumulation_steps=2, max_train_steps=-1, max_train_epoch=1,
                      checkpointing_steps=-1, checkpointing_epochs=1)
    m = train("lora", cfg, device="cpu")
    assert m["steps"] == 1 and [c["step"] for c in m["checkpoints"]] == [1]


def test_profile_window_writes_a_trace(fixture_kwargs, tmp_path):
    cfg = tiny_config("lora", fixture_kwargs, tmp_path, profile_steps=1, enable_validation=True,
                      validation_steps=2, validation_steps_tuple=[])
    cfg["validation_data"] = dict(cfg["validation_data"], num_inference_steps=1, num=1)
    m = train("lora", cfg, max_steps=3, device="cpu")
    traces = glob.glob(os.path.join(m["run_dir"], "trace", "*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    assert [v["step"] for v in m["validations"]] == [2]
    assert m["validations"][0]["files"] == ["validation.png"] and not m["validations"][0]["error"]
    assert os.path.exists(os.path.join(m["run_dir"], "samples", "2", "validation.png"))


def test_failed_validation_is_logged_and_training_goes_on(fixture_kwargs, tmp_path):
    cfg = tiny_config("obj", fixture_kwargs, tmp_path, enable_validation=True,
                      validation_steps_tuple=[1])
    cfg["validation_data"] = dict(cfg["validation_data"], num_inference_steps=1, num=1,
                                  guidance_scale="not a number")
    m = train("obj", cfg, max_steps=2, device="cpu")
    assert m["steps"] == 2 and m["validations"][0]["error"]
    log = open(os.path.join(m["run_dir"], "log.txt")).read()
    assert "validation at step 1 failed" in log


@pytest.mark.parametrize("stage", ["lora", "obj"])
def test_script_runs_each_stage(fixture_kwargs, tmp_path, capsys, stage):
    import yaml

    path = tmp_path / f"{stage}.yaml"
    path.write_text(yaml.safe_dump(tiny_config(stage, fixture_kwargs, tmp_path / "out")))
    train_script.main(["--stage", stage, "--config", str(path), "--max-steps", "1",
                       "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "'steps': 1" in out


@pytest.mark.parametrize("stage", ["lora", "obj"])
def test_stages_need_a_gpu_unless_cpu_asked(fixture_kwargs, tmp_path, monkeypatch, stage):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(stage, tiny_config(stage, fixture_kwargs, tmp_path / "out"), max_steps=1)
    assert not os.path.exists(tmp_path / "out")


def test_obj_stage_needs_a_cmc_checkpoint(fixture_kwargs, tmp_path):
    cfg = tiny_config("obj", fixture_kwargs, tmp_path, allow_untrained_cm=False)
    with pytest.raises(FileNotFoundError, match="CMC checkpoint"):
        train("obj", cfg, max_steps=1, device="cpu")
