"""The port's stage-2 trainer from files, on the CPU.

The cam config of configs/cam.yaml at the tiny widths of
tests/test_trainers.py (UNet 32/64/128/128, 4 heads, 1 CLIP layer), fp32,
batch 1, 2 frames at 64x64, on a fixture of 2 sequences x 48 frames at
64x96 (so an epoch is 2 steps and a 5-step run ends mid-epoch):

- the config's SD1.5 directory and motion-module file reach the trained
  model, and its tokenizer is the CLIP BPE tokenizer of the directory;
- 3 steps then ``resume_from: auto`` to 5 equals 5 uninterrupted steps bit
  for bit (losses after the resume, masters, moments);
- prefetch and the async writer equal the serial path bit for bit;
- the ``cmcm-step-5.ckpt`` bundle loads into the JAX package's params
  (``torch_load_state_dict`` + ``load_into_params``) as the port's masters,
  and its optimizer state is keyed as the JAX trainer's
  ``_export_optimizer_state`` keys it;
- SIGTERM through ``python -m synfmc_tpu_torch.scripts.train`` exits 0 with
  ``'preempted': True`` and a checkpoint that resumes;
- ``ckpt_device_snapshot``: ``auto`` and ``never`` take the host copy on the
  CPU, ``always`` the device snapshot, and all write the same ``state.pt``;
  another value raises before any run directory.

No JAX program is compiled: the JAX side is numpy code and param shapes.
"""

import ast
import copy
import glob
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from synfmc_tpu.config import ConfigDict
from synfmc_tpu.training import checkpoint as jckpt
from synfmc_tpu.training.params import partition_params as jax_partition
from synfmc_tpu.training.params import stage2_cmc_unet_trainable as jax_stage2
from synfmc_tpu.training.trainers import _export_optimizer_state
from synfmc_tpu.training.trainers import build_models as jax_build_models
from synfmc_tpu_torch.config import load_config
from synfmc_tpu_torch.data.fixture import build_synthetic_dataset
from synfmc_tpu_torch.data.tokenizer import CLIPTokenizer, load_tokenizer
from synfmc_tpu_torch.interop.torch_port import jax_state_dict
from synfmc_tpu_torch.pipelines.factory import init_models
from synfmc_tpu_torch.scripts import train as train_script
from synfmc_tpu_torch.training import checkpoint as ckpt
from synfmc_tpu_torch.training import trainers
from synfmc_tpu_torch.training.trainers import train
from tests.test_torch_modules import randomize, shapes
from tests.test_torch_tokenizer import write_bpe_vocab
from tests.test_trainers import TINY_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, W = 2, 64, 64


@pytest.fixture(scope="module")
def fixture_kwargs(tmp_path_factory):
    root = tmp_path_factory.mktemp("synfmc_train")
    return build_synthetic_dataset(str(root), num_seqs=2, num_objects=2, num_frames=48)


def tiny_config(fixture_kwargs, output_dir, **extra) -> dict:
    cfg = load_config(os.path.join(REPO, "configs", "cam.yaml"))
    cfg.update(output_dir=str(output_dir), model_overrides=copy.deepcopy(TINY_OVERRIDES),
               train_batch_size=1, checkpointing_steps=2, logger_interval=1, num_workers=2,
               mixed_precision_training=False, record_loss_history=True)
    cfg.update(extra)
    cfg["train_data"]["params"].update(fixture_kwargs, sample_size=[H, W], sample_n_frames=F,
                                       max_objects=2)
    return cfg


def native(run_dir: str, step: int) -> dict:
    return ckpt.restore_native(os.path.join(run_dir, "checkpoints", f"step-{step}"))


def assert_same_state(a: dict, b: dict) -> None:
    assert (a["step"], a["epoch"], a["count"]) == (b["step"], b["epoch"], b["count"])
    for key in ("masters", "exp_avg", "exp_avg_sq"):
        assert a[key].keys() == b[key].keys()
        bad = [n for n in a[key] if not torch.equal(a[key][n], b[key][n])]
        assert not bad, f"{key}: {len(bad)} tensors differ, e.g. {bad[:3]}"


@pytest.fixture(scope="module")
def runs(fixture_kwargs, tmp_path_factory):
    """5 steps with prefetch 2 and the async writer; 5 steps serial; 3 steps,
    then ``resume_from: auto`` to 5 in the same output directory."""
    root = tmp_path_factory.mktemp("runs")
    out = {"a": train("cam", tiny_config(fixture_kwargs, root / "a", prefetch_batches=2),
                      max_steps=5, device="cpu"),
           "serial": train("cam", tiny_config(fixture_kwargs, root / "s", prefetch_batches=0,
                                              async_checkpointing=False),
                           max_steps=5, device="cpu"),
           "b": train("cam", tiny_config(fixture_kwargs, root / "b"), max_steps=3, device="cpu")}
    out["c"] = train("cam", tiny_config(fixture_kwargs, root / "b", resume_from="auto"),
                     max_steps=5, device="cpu")
    return out


def test_resume_is_exact(runs):
    a, b, c = runs["a"], runs["b"], runs["c"]
    assert a["steps"] == c["steps"] == 5 and b["steps"] == 3
    assert len(a["loss_history"]) == 5 and len(c["loss_history"]) == 2
    np.testing.assert_array_equal(np.asarray(a["loss_history"][3:]),
                                  np.asarray(c["loss_history"]))
    np.testing.assert_array_equal(np.asarray(a["loss_history"][:3]),
                                  np.asarray(b["loss_history"]))
    assert_same_state(native(a["run_dir"], 2), native(b["run_dir"], 2))
    assert_same_state(native(a["run_dir"], 5), native(c["run_dir"], 5))
    assert native(a["run_dir"], 5)["epoch"] == 2  # 2 steps an epoch: mid-epoch 2


def test_prefetch_and_async_writer_equal_serial(runs):
    a, s = runs["a"], runs["serial"]
    np.testing.assert_array_equal(np.asarray(a["loss_history"]), np.asarray(s["loss_history"]))
    for step in (2, 4, 5):
        assert_same_state(native(a["run_dir"], step), native(s["run_dir"], step))
    assert [c["step"] for c in a["checkpoints"]] == [2, 4, 5]


def jax_templates(cfg) -> dict:
    """The JAX cam-stage UNet and pose-encoder param trees (seeded values;
    shapes from the traced init)."""
    models = jax_build_models(ConfigDict(cfg), "cam")
    chs = TINY_OVERRIDES["block_out_channels"]
    key = jax.random.PRNGKey(0)
    pose = [jnp.zeros((1, F, H // 8 // 2**i, W // 8 // 2**i, c)) for i, c in enumerate(chs)]
    unet = shapes(models["unet"], key, jnp.zeros((1, F, H // 8, W // 8, 4)),
                  jnp.zeros((1,), jnp.int32),
                  jnp.zeros((1, 77, TINY_OVERRIDES["cross_attention_dim"])), pose_features=pose)
    enc = shapes(models["pose_encoder"], key, jnp.zeros((1, F, H, W, 6)))
    return {"unet": randomize(unet, seed=1)["params"],
            "pose_encoder": randomize(enc, seed=2)["params"]}


def test_bundle_loads_into_jax(runs, fixture_kwargs, tmp_path):
    a = runs["a"]
    path = os.path.join(a["run_dir"], "checkpoints", "cmcm-step-5.ckpt")
    masters = native(a["run_dir"], 5)["masters"]
    cfg = tiny_config(fixture_kwargs, tmp_path)
    template = jax_templates(cfg)
    bundle = jckpt.torch_load_state_dict(path)
    assert (bundle["epoch"], bundle["global_step"]) == (2, 5)
    pose = jckpt.load_into_params(template["pose_encoder"], bundle["pose_encoder_state_dict"],
                                  "pose_encoder")
    unet = jckpt.load_into_params(template["unet"], bundle["attention_processor_state_dict"],
                                  "unet")
    got = {"pose_encoder." + k: v for k, v in jax_state_dict(pose, "pose_encoder").items()}
    merge = {"unet." + k: v for k, v in jax_state_dict(unet, "unet").items() if "merge" in k}
    got.update(merge)
    assert got.keys() == masters.keys()
    bad = [n for n, v in got.items() if not np.array_equal(v, masters[n].numpy())]
    assert not bad, f"{len(bad)} tensors differ after the JAX package's load, e.g. {bad[:3]}"

    # the optimizer state: the JAX trainer's names, order and groups
    t_unet, _ = jax_partition(template["unet"], jax_stage2)
    trainable = {"unet": t_unet, "pose_encoder": template["pose_encoder"]}
    jstate = SimpleNamespace(opt_state=SimpleNamespace(count=np.int32(5), mu=trainable,
                                                       nu=trainable))
    want = _export_optimizer_state("cam", jstate, ConfigDict(cfg))
    opt = bundle["optimizer_state_dict"]
    assert opt["param_names"] == want["param_names"]
    assert opt["param_groups"] == want["param_groups"]
    for i, name in enumerate(opt["param_names"]):
        state, ref = opt["state"][i], want["state"][i]
        assert state.keys() == ref.keys() and float(state["step"]) == float(ref["step"]) == 5
        assert state["exp_avg"].shape == ref["exp_avg"].shape, name
    saved = native(a["run_dir"], 5)
    by_name = {n.split(".", 1)[1]: n for n in saved["masters"]}
    assert sorted(by_name) == sorted(opt["param_names"])
    for i, name in enumerate(opt["param_names"]):
        for key in ("exp_avg", "exp_avg_sq"):
            assert np.array_equal(opt["state"][i][key], saved[key][by_name[name]].numpy()), name


def test_config_files_reach_the_trained_model(fixture_kwargs, tmp_path, monkeypatch):
    """A real ``pretrained_model_path`` and ``motion_module_ckpt`` reach the
    trained UNet (spied right after the load, before any step), and the
    directory's tokenizer makes the token ids."""
    cfg = tiny_config(fixture_kwargs, tmp_path / "out", strict_pretrained=True)
    src = init_models(cfg, "cam", seed=123, device="cpu")["unet"].state_dict()
    sd = tmp_path / "sd15"
    os.makedirs(sd / "unet")
    spatial = {k: v for k, v in src.items() if "motion_modules" not in k and ".processor." not in k}
    torch.save(spatial, sd / "unet" / "diffusion_pytorch_model.bin")
    write_bpe_vocab(str(sd / "tokenizer"))
    motion = {k: v for k, v in src.items() if "motion_modules" in k and ".processor." not in k}
    torch.save({"state_dict": motion}, tmp_path / "mm.ckpt")
    cfg.update(pretrained_model_path=str(sd), motion_module_ckpt=str(tmp_path / "mm.ckpt"))

    loaded, ids = {}, []
    load, host = trainers.load_pretrained, trainers.host_batch

    def spy_load(models, config, stage, log):
        out = load(models, config, stage, log)
        loaded.update({k: v.clone() for k, v in models["unet"].state_dict().items()})
        return out

    def spy_host(raw, tokenizer, device):
        batch = host(raw, tokenizer, device)
        ids.append((raw["captions"], batch["input_ids"].numpy()))
        return batch

    monkeypatch.setattr(trainers, "load_pretrained", spy_load)
    monkeypatch.setattr(trainers, "host_batch", spy_host)
    train("cam", cfg, max_steps=1, device="cpu")
    for part in (motion, spatial):
        bad = [k for k, v in part.items() if not torch.equal(loaded[k], v)]
        assert not bad, f"{len(bad)} of {len(part)} file tensors did not reach the UNet: {bad[:3]}"
    tok = load_tokenizer(str(sd))
    assert isinstance(tok, CLIPTokenizer)
    assert ids and all(np.array_equal(got, tok(caps)) for caps, got in ids)


def test_sigterm_stops_cleanly_and_resumes(fixture_kwargs, tmp_path):
    cfg = tiny_config(fixture_kwargs, tmp_path / "out", checkpointing_steps=100,
                      do_sanity_check=False)
    path = tmp_path / "cam.yaml"
    path.write_text(yaml.safe_dump(cfg))
    proc = subprocess.Popen(
        [sys.executable, "-m", "synfmc_tpu_torch.scripts.train", "--stage", "cam", "--config",
         str(path), "--max-steps", "1000", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and proc.poll() is None:
            logs = glob.glob(str(tmp_path / "out" / "*" / "log.txt"))
            if logs and "step 2/1000" in open(logs[0]).read():
                break
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    metrics = ast.literal_eval(stdout.strip().splitlines()[-1])
    assert metrics["preempted"] is True and metrics["steps"] >= 2
    step = metrics["steps"]
    assert ckpt.find_auto_resume(str(tmp_path / "out"), cfg["name"]).endswith(f"step-{step}")
    cfg["resume_from"] = "auto"
    resumed = train("cam", cfg, max_steps=step + 1, device="cpu")
    assert resumed["steps"] == step + 1 and len(resumed["loss_history"]) == 1
    assert np.isfinite(resumed["loss_history"]).all()


@pytest.mark.parametrize("mode,path", [("auto", "host copy"), ("never", "host copy"),
                                       ("always", "snapshot")])
def test_ckpt_device_snapshot_writes_the_same_state(runs, fixture_kwargs, tmp_path, mode, path):
    """Each mode's checkpoint path (the device cannot say on the CPU whether
    a snapshot fits, so ``auto`` copies to the host), and the same state.pt
    as run a's (``auto``, the default) at step 2."""
    assert not trainers.snapshot_fits_on_device(1, device="cpu")
    if mode == "auto":
        out = runs["a"]
    else:
        out = train("cam", tiny_config(fixture_kwargs, tmp_path, prefetch_batches=2,
                                       ckpt_device_snapshot=mode), max_steps=2, device="cpu")
        np.testing.assert_array_equal(out["loss_history"], runs["a"]["loss_history"][:2])
    assert [c["path"] for c in out["checkpoints"]][:1] == [path]
    assert out["assembled"][0] == 2
    assert_same_state(native(out["run_dir"], 2), native(runs["a"]["run_dir"], 2))


def test_unknown_snapshot_mode_raises(fixture_kwargs, tmp_path):
    cfg = tiny_config(fixture_kwargs, tmp_path, ckpt_device_snapshot="sometimes")
    with pytest.raises(ValueError, match="ckpt_device_snapshot"):
        train("cam", cfg, max_steps=1, device="cpu")
    assert not os.listdir(tmp_path)  # before any run directory or model


def test_script_needs_a_gpu_unless_cpu_asked(fixture_kwargs, tmp_path, monkeypatch):
    path = tmp_path / "cam.yaml"
    path.write_text(yaml.safe_dump(tiny_config(fixture_kwargs, tmp_path / "out")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_script.main(["--stage", "cam", "--config", str(path), "--max-steps", "1"])
    assert not os.path.exists(tmp_path / "out")
