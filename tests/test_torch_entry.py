"""The port's entry points on the CPU: ``python -m
synfmc_tpu_torch.scripts.generate --cpu`` writes a GIF whose frames match an
in-process run, and ``python -m synfmc_tpu_torch.scripts.serve --cpu --port 0``
answers /healthz, coalesces two concurrent requests into one bucket of 2,
answers 400 for a bad camera and 500 for a group that fails, and serves on.

Files in the reference layout are written from a tiny obj-stage pipeline's
seeded weights (SD1.5 directory with safetensors and .bin weights and a BPE
tokenizer, a motion-module checkpoint, LoRA, CMC and OMC bundles), and a
config that points at them.  No JAX program runs here.
"""

import copy
import json
import os
import re
import subprocess
import sys
import threading

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import save_file

from chip_smoke import Daemon, http
from synfmc_tpu_torch.config import load_config
from synfmc_tpu_torch.data.tokenizer import CLIPTokenizer
from synfmc_tpu_torch.pipelines.factory import build_pipeline, randomize_pipeline_
from synfmc_tpu_torch.scripts.generate import camera_plucker, object_features
from tests.test_torch_slice import TINY
from tests.test_torch_tokenizer import write_bpe_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, W, STEPS = 4, 64, 64, 2
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def camera_text(frames: int) -> str:
    """A camera label file (save_camera_info_txt layout): a slow pan along x."""
    lines = [str(frames)]
    for i in range(frames):
        rt = [1, 0, 0, 0.1 * i, 0, 1, 0, 0, 0, 0, 1, 0]
        lines.append(" ".join(str(v) for v in [i, W, H, W / 2, H / 2, 0, 0] + rt))
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry")
    cfg = copy.deepcopy(load_config(os.path.join(REPO, "configs", "obj.yaml")))
    cfg["model_overrides"] = copy.deepcopy(TINY)
    cfg["unet_additional_kwargs"]["motion_module_kwargs"]["num_attention_heads"] = 4
    cfg["pose_encoder_kwargs"]["temporal_attention_nhead"] = 4
    cfg["mixed_precision_training"] = False
    cfg["train_data"]["params"]["sample_size"] = [H, W]
    pipe, _ = build_pipeline(cfg, stage="obj", device="cpu", allow_untrained_cm=True)
    randomize_pipeline_(pipe, 0)
    unet = {k: v.contiguous() for k, v in pipe.unet.state_dict().items()}
    sd = root / "sd"
    for sub in ("unet", "vae", "text_encoder"):
        os.makedirs(sd / sub)
    save_file({k: v for k, v in unet.items() if "motion_modules" not in k and ".processor." not in k},
              str(sd / "unet" / "diffusion_pytorch_model.safetensors"))
    save_file({k: v.contiguous().half() for k, v in pipe.vae.state_dict().items()},
              str(sd / "vae" / "diffusion_pytorch_model.safetensors"))
    torch.save(pipe.text_encoder.state_dict(), str(sd / "text_encoder" / "pytorch_model.bin"))
    write_bpe_vocab(str(sd / "tokenizer"))
    torch.save({"state_dict": {k: v for k, v in unet.items()
                               if "motion_modules" in k and ".processor." not in k}},
               str(root / "mm.ckpt"))
    torch.save({"lora_state_dict": {k: v for k, v in unet.items() if "_lora." in k}},
               str(root / "lora.ckpt"))
    torch.save({"pose_encoder_state_dict": pipe.pose_encoder.state_dict(),
                "attention_processor_state_dict": {k: v for k, v in unet.items() if "_merge." in k}},
               str(root / "cmc.ckpt"))
    torch.save({"omcm_state_dict": pipe.adapter.state_dict(), "global_step": 5},
               str(root / "omcm.ckpt"))
    cfg.update(pretrained_model_path=str(sd), motion_module_ckpt=str(root / "mm.ckpt"),
               lora_ckpt=str(root / "lora.ckpt"), pretrained_cm_path=str(root / "cmc.ckpt"))
    with open(root / "config.yaml", "w") as fh:
        yaml.safe_dump(cfg, fh)
    (root / "camera.txt").write_text(camera_text(F))
    rng = np.random.default_rng(4)
    masks = np.zeros((F, 2, H, W), np.float32)
    masks[:, 0, 8:30, 10:40] = 1.0
    masks[:, 1, 30:60, 20:50] = 0.5
    np.savez(root / "objects.npz", obj_info=rng.normal(size=(F, 2, 12)).astype(np.float32),
             obj_masks=masks)
    return root


def test_generate_cli_writes_the_gif(files):
    out, frames_npz = files / "out" / "clip.gif", files / "frames.npz"
    prompt = "a knight marches across a field!"
    cmd = [sys.executable, "-m", "synfmc_tpu_torch.scripts.generate",
           "--config", str(files / "config.yaml"), "--prompt", prompt, "--cpu",
           "--num-inference-steps", str(STEPS), "--video-length", str(F),
           "--camera-txt", str(files / "camera.txt"), "--obj-traj-npz", str(files / "objects.npz"),
           "--omcm-ckpt", str(files / "omcm.ckpt"), "--out", str(out),
           "--save-frames", str(frames_npz), "--seed", "7"]
    proc = subprocess.run(cmd, cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.search(r"# generate: device cpu, load [\d.]+ s, denoise [\d.]+ s", proc.stdout)
    frames = imageio.mimread(str(out))
    assert len(frames) == F and frames[0].shape[:2] == (H, W)
    with imageio.get_reader(str(out)) as reader:
        assert reader.get_meta_data()["loop"] == 0

    # the same request in process: the same token ids and frames
    pipe, info = build_pipeline(str(files / "config.yaml"), omcm_ckpt=str(files / "omcm.ckpt"),
                                seed=7, device="cpu")
    assert info["stage"] == "obj" and isinstance(pipe.tokenizer, CLIPTokenizer)
    from synfmc_tpu_torch.evaluation.metrics import parse_camera_txt

    video = pipe([prompt], video_length=F, height=H, width=W, num_inference_steps=STEPS,
                 generator=torch.Generator().manual_seed(7),
                 plucker=camera_plucker((H, W), 1, F, parse_camera_txt(str(files / "camera.txt"))),
                 traj_features=object_features(pipe, str(files / "objects.npz"), 1))
    with np.load(frames_npz) as saved:
        assert saved["input_ids"].tolist() == pipe.tokenizer([prompt]).tolist()
        np.testing.assert_allclose(saved["video"], video.numpy(), atol=1e-5, rtol=0)


def post(port, body):
    code, ctype, data, _ = http(port, "/generate", body, timeout=240)
    return code, ctype, data


def test_serve_daemon_batches_and_validates(files, tmp_path):
    daemon = Daemon(["--config", str(files / "config.yaml"), "--cpu", "--port", "0",
                     "--max-batch", "2", "--batch-window", "2", "--video-length", str(F),
                     "--num-inference-steps", str(STEPS), "--warmup"])
    try:
        port = int(daemon.wait_for(r"listening on 127\.0\.0\.1:(\d+)", 240)[0].group(1))
        code, _, body, _ = http(port, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["backend"] == "cpu" and health["stage"] == "cam"
        assert health["sample_size"] == [H, W]

        results = [None, None]

        def ask(i):
            results[i] = post(port, {"prompt": f"a red car drives {i}", "seed": i,
                                     "camera_txt": camera_text(F)})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
            assert not t.is_alive()
        for i, (code, ctype, data) in enumerate(results):
            assert code == 200 and ctype == "image/gif", (code, data[:200])
            path = tmp_path / f"served{i}.gif"
            path.write_bytes(data)
            assert len(imageio.mimread(str(path))) == F
        daemon.wait_for(r"batched 2 request\(s\), 2 sample\(s\) -> bucket 2", 60)

        code, _, body = post(port, {"prompt": "x", "camera_txt": camera_text(F - 1)})
        assert code == 400 and b"poses but video_length" in body
        code, _, body = post(port, {"prompt": "x", "camera_txt": "not a camera"})
        assert code == 400 and b"bad camera_txt" in body
        # a group that fails inside the pipeline (more frames than the pose
        # encoder's 16 positions) answers 500, and the daemon serves on
        code, _, body = post(port, {"prompt": "x", "video_length": 20})
        assert code == 500
        assert http(port, "/healthz")[0] == 200
    finally:
        daemon.close()
