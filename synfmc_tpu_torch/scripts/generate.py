"""Generation command line: camera- and object-conditioned video from checkpoints.

The port of scripts/generate.py, on the GPU unless ``--cpu`` is given:

    python -m synfmc_tpu_torch.scripts.generate --config configs/cam.yaml \\
        --prompt "a girl is walking" \\
        --lora-ckpt lora.ckpt --cm-ckpt cmcm.ckpt [--omcm-ckpt omcm.ckpt] \\
        [--camera-txt camera.txt] [--obj-traj-npz objects.npz] --out out.gif

The config's checkpoint paths (``pretrained_model_path``: an SD1.5
diffusers directory; ``motion_module_ckpt``; ``lora_ckpt``;
``pretrained_cm_path``) load as ``pipelines.factory.build_pipeline`` says.
On N GPUs, one process each (``--frame-parallel S`` needs 2 x prompts x S
ranks, the CFG pair on the data axis):

    python -m torch.distributed.run --nproc-per-node N \\
        -m synfmc_tpu_torch.scripts.generate ... --data-parallel N

Every rank builds the same pipeline, runs its share and holds the whole
result; rank 0 alone writes the GIF and the ``--save-frames`` file.

The initial latents come from ``torch.Generator(device).manual_seed(seed)``.
One line, ``# generate: ...``, gives the seconds spent loading, denoising,
decoding and encoding the GIF, the peak device memory and the kernel
launches; ``--save-frames`` also writes the decoded frames (before the GIF's
quantization) and the prompts' token ids to an ``.npz``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m synfmc_tpu_torch.scripts.generate")
    p.add_argument("--config", required=True)
    p.add_argument("--prompt", action="append", required=True)
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--lora-ckpt", default=None)
    p.add_argument("--cm-ckpt", default=None, help="stage-2 CMC bundle")
    p.add_argument("--omcm-ckpt", default=None, help="stage-3 OMC bundle")
    p.add_argument("--camera-txt", default=None, help="camera label txt for the trajectory")
    p.add_argument("--obj-traj-npz", default=None,
                   help="object trajectories for OMC: npz with obj_info (F,O,12) "
                        "camera-relative poses and obj_masks (F,O,H,W) in [0,1]")
    p.add_argument("--num-inference-steps", type=int, default=25)
    p.add_argument("--guidance-scale", type=float, default=8.0)
    p.add_argument("--video-length", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="output/generated.gif")
    p.add_argument("--save-frames", default=None, metavar="NPZ",
                   help="also write the decoded frames in [0, 1] (before the GIF's "
                        "palette) and the prompts' token ids")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    p.add_argument("--allow-untrained-cm", action="store_true",
                   help="bypass the stage-3 trained-CMC requirement (smoke tests only)")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="split the prompts over N ranks (under torch.distributed.run)")
    p.add_argument("--frame-parallel", type=int, default=0, metavar="S",
                   help="split the frames over S ranks, the CFG pair over 2 x prompts "
                        "(under torch.distributed.run)")
    p.add_argument("--deepcache", type=int, default=1, metavar="N",
                   help="DeepCache interval: deep UNet levels refresh every Nth step")
    p.add_argument("--cfg-cache", type=int, default=1, metavar="N",
                   help="CFG-cache interval: the uncond branch every Nth step only")
    p.add_argument("--turbo", type=int, default=0, metavar="N",
                   help="shorthand for --deepcache N --cfg-cache N")
    p.add_argument("--decode-chunk", type=int, default=1, metavar="K",
                   help="VAE-decode K frames a call (same values, more memory)")
    p.add_argument("--solver", choices=("ddim", "dpmpp_2m"), default="ddim")
    args = p.parse_args(argv)
    if args.turbo:
        args.deepcache = args.cfg_cache = args.turbo
    if args.obj_traj_npz and not args.omcm_ckpt:
        p.error("--obj-traj-npz requires --omcm-ckpt")
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if (args.data_parallel > 1 or args.frame_parallel) and not launched:
        p.error("--data-parallel N > 1 and --frame-parallel run one process a GPU: launch "
                "python -m torch.distributed.run --nproc-per-node <ranks> -m "
                "synfmc_tpu_torch.scripts.generate ...")
    return args


def camera_plucker(sample_size, batch: int, frames: int, camera=None, device=None):
    """Plücker rays (batch, F, H, W, 6) of a parsed camera (intrinsics (F, 4),
    RT (F, 3, 4)), or of the neutral straight-ahead trajectory."""
    from synfmc_tpu_torch.geometry.plucker import plucker_embedding

    h, w = sample_size
    if camera is not None:
        intr, rts = camera
        c2w = np.tile(np.eye(4, dtype=np.float32), (len(rts), 1, 1))
        c2w[:, :3, :] = rts
        intr = np.tile(np.asarray(intr, np.float32)[None], (batch, 1, 1))
        c2w = np.tile(c2w[None], (batch, 1, 1, 1))
    else:
        intr = np.broadcast_to(np.array([w, h, 0, 0], np.float32), (batch, frames, 4))
        c2w = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, frames, 4, 4))
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    return plucker_embedding(as_t(intr), as_t(c2w), h, w)


def object_features(pipe, npz_path: str, batch: int):
    """Traj features of an ``--obj-traj-npz`` file through the ObjectAdapter,
    repeated for each prompt."""
    from synfmc_tpu_torch.utils.traj_features import build_adapter_inputs

    with np.load(npz_path) as rec:
        info = torch.as_tensor(rec["obj_info"], dtype=torch.float32)[None]  # (1,F,O,12)
        masks = torch.as_tensor(rec["obj_masks"], dtype=torch.float32)[None]  # (1,F,O,H,W)
    feats, mask = build_adapter_inputs(info.to(pipe.device), masks.to(pipe.device))
    traj = pipe.encode_traj(feats, mask, info.shape[1])
    return [t.repeat(batch, 1, 1, 1, 1) for t in traj] if batch > 1 else traj


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch.distributed as dist

    from synfmc_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    if (args.data_parallel or args.frame_parallel) and "RANK" in os.environ:
        pmesh.init_distributed(device="cpu" if args.cpu else None)
    try:
        return _run(args, t0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, t0: float) -> int:
    from synfmc_tpu_torch.config import load_config
    from synfmc_tpu_torch.evaluation.metrics import parse_camera_txt
    from synfmc_tpu_torch.ops import kernel_launches
    from synfmc_tpu_torch.parallel import mesh as pmesh
    from synfmc_tpu_torch.pipelines.animation import decode_latents
    from synfmc_tpu_torch.pipelines.factory import build_pipeline
    from synfmc_tpu_torch.utils.video import videos_grid_gif

    config = load_config(args.config)
    pipe, info = build_pipeline(
        config, seed=args.seed, video_length=args.video_length, lora_ckpt=args.lora_ckpt,
        cm_ckpt=args.cm_ckpt, omcm_ckpt=args.omcm_ckpt,
        allow_untrained_cm=args.allow_untrained_cm, data_parallel=args.data_parallel,
        frame_parallel=args.frame_parallel, batch=len(args.prompt),
        device="cpu" if args.cpu else None)
    dev = pipe.device
    _sync(dev)
    t_load = time.perf_counter() - t0

    h, w = info["sample_size"]
    b, f = len(args.prompt), args.video_length
    camera = parse_camera_txt(args.camera_txt) if args.camera_txt else None
    launches0 = kernel_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    plucker = camera_plucker((h, w), b, f, camera, dev)
    traj = object_features(pipe, args.obj_traj_npz, b) if args.obj_traj_npz else None
    latents = pipe(args.prompt, video_length=f, height=h, width=w,
                   num_inference_steps=args.num_inference_steps,
                   guidance_scale=args.guidance_scale, negative_prompts=args.negative_prompt,
                   generator=torch.Generator(device=dev).manual_seed(args.seed),
                   plucker=plucker, traj_features=traj,
                   omcm_min_step=int(config.get("omcm_min_step", 700)),
                   deepcache_interval=args.deepcache, cfg_cache_interval=args.cfg_cache,
                   solver=args.solver, decode=False)
    _sync(dev)
    t_denoise = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        video = decode_latents(pipe.vae, latents, decode_chunk=args.decode_chunk, mesh=pipe.mesh)
    video = video.float().cpu().numpy()
    t_decode = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0

    where = f"rank {pmesh.rank()}/{pmesh.world_size()}, " if pmesh.world_size() > 1 else ""
    gif = ""
    if pmesh.is_main_process():
        t0 = time.perf_counter()
        data = videos_grid_gif(video)
        t_gif = time.perf_counter() - t0
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "wb") as fh:
            fh.write(data)
        if args.save_frames:
            np.savez(args.save_frames, video=video, input_ids=pipe.tokenizer(args.prompt))
        gif = f", gif {t_gif * 1e3:.1f} ms ({len(data)} bytes)"
    print(f"# generate: {where}device {dev}, load {t_load:.3f} s, denoise {t_denoise:.3f} s "
          f"({args.num_inference_steps} steps), decode {t_decode:.3f} s{gif}, peak "
          f"{peak:.2f} GiB, launches {launches}", flush=True)
    if pmesh.is_main_process():
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
