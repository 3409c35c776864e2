"""Serving daemon for camera-controlled video, on the GPU unless ``--cpu``.

The port of scripts/serve.py: the pipeline the command line builds, behind a
dependency-free HTTP API, with a micro-batcher that coalesces concurrent
requests of one shape into one batched pipeline call:

    python -m synfmc_tpu_torch.scripts.serve --config configs/cam.yaml \\
        --cm-ckpt cmcm.ckpt [--turbo 3] [--solver dpmpp_2m] [--port 8000] \\
        [--max-batch 2 --batch-window 0.5] [--warmup]

    GET  /healthz   -> {"status": "ok", "stage", "sample_size", "backend": "cuda" | "cpu"}
    POST /generate  -> image/gif bytes
         JSON body: {"prompt": "a red car drives" | [...], "num_inference_steps": 25,
                     "guidance_scale": 8.0, "seed": 42, "video_length": 16,
                     "camera_txt": "<camera label txt content>"}  # optional

``camera_txt`` is the camera label format generate.py's ``--camera-txt``
reads; a body that does not parse, or whose pose count differs from
``video_length``, is answered 400 before it joins a group.  An error inside a
group answers 500 to each of its requests and the daemon serves on.
``--port 0`` binds a free port; the "listening on" line names it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m synfmc_tpu_torch.scripts.serve")
    p.add_argument("--config", required=True)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--lora-ckpt", default=None)
    p.add_argument("--cm-ckpt", default=None)
    p.add_argument("--omcm-ckpt", default=None)
    p.add_argument("--allow-untrained-cm", action="store_true")
    p.add_argument("--video-length", type=int, default=16)
    p.add_argument("--num-inference-steps", type=int, default=25)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--deepcache", type=int, default=1)
    p.add_argument("--cfg-cache", type=int, default=1)
    p.add_argument("--turbo", type=int, default=0,
                   help="shorthand for --deepcache N --cfg-cache N")
    p.add_argument("--solver", choices=("ddim", "dpmpp_2m"), default="ddim")
    p.add_argument("--decode-chunk", type=int, default=1)
    p.add_argument("--warmup", action="store_true",
                   help="run one generation at startup, so the first request does not "
                        "pay the first-call set-up")
    p.add_argument("--max-batch", type=int, default=1,
                   help="coalesce concurrent same-shape requests into one batched "
                        "pipeline call, up to this many samples (power-of-two buckets)")
    p.add_argument("--batch-window", type=float, default=0.0,
                   help="seconds to wait for same-shape followers after picking up a "
                        "request (0 = coalesce only requests already queued)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = p.parse_args(argv)
    if args.turbo:
        args.deepcache = args.cfg_cache = args.turbo
    return args


def make_run_group(args, pipe, info):
    """The batched pipeline call the MicroBatcher dispatches: each job's
    latents from its own seed, the group padded to a power-of-two bucket,
    the outputs split back per job (float32 numpy, (n, F, H, W, 3))."""
    from synfmc_tpu_torch.ops import kernel_launches
    from synfmc_tpu_torch.scripts.generate import camera_plucker
    from synfmc_tpu_torch.serving.batcher import bucket_size

    dev = pipe.device

    def run_group(jobs, key):
        f, steps, guidance = key
        h, w = info["sample_size"]
        prompts = [p for j in jobs for p in j.prompts]
        lat = [torch.randn((j.n, f, h // 8, w // 8, 4),
                           generator=torch.Generator(device=dev).manual_seed(j.seed),
                           device=dev) * pipe.schedule.init_noise_sigma for j in jobs]
        plks = [camera_plucker((h, w), j.n, f, j.camera, dev) for j in jobs]
        n = len(prompts)
        pad = bucket_size(n, args.max_batch) - n
        if pad:
            prompts = prompts + [prompts[-1]] * pad
            lat.append(lat[-1][-1:].repeat(pad, 1, 1, 1, 1))
            plks.append(plks[-1][-1:].repeat(pad, 1, 1, 1, 1))
        before, t0 = kernel_launches(), time.perf_counter()
        video = pipe(prompts, video_length=f, height=h, width=w, num_inference_steps=steps,
                     guidance_scale=guidance, latents=torch.cat(lat), plucker=torch.cat(plks),
                     deepcache_interval=args.deepcache, cfg_cache_interval=args.cfg_cache,
                     solver=args.solver, decode_chunk=args.decode_chunk)
        video = video.float().cpu().numpy()
        launches = {k: v - before[k] for k, v in kernel_launches().items()}
        print(f"# serve: batched {len(jobs)} request(s), {n} sample(s) -> bucket {n + pad}, "
              f"launches {launches} in {time.perf_counter() - t0:.3f}s", flush=True)
        out, ofs = [], 0
        for j in jobs:
            out.append(video[ofs:ofs + j.n])
            ofs += j.n
        return out

    return run_group


def make_handler(args, pipe, info, batcher):
    from http.server import BaseHTTPRequestHandler

    from synfmc_tpu_torch.evaluation.metrics import parse_camera_text
    from synfmc_tpu_torch.serving.batcher import Job
    from synfmc_tpu_torch.utils.video import videos_grid_gif

    dev = pipe.device

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # one line on stdout
            print(f"# serve: {fmt % a}", flush=True)

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "stage": info["stage"],
                                 "sample_size": list(info["sample_size"]),
                                 "backend": dev.type})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompts = req.get("prompt") or req.get("prompts")
                if isinstance(prompts, str):
                    prompts = [prompts]
                if not prompts:
                    self._json(400, {"error": "missing 'prompt'"})
                    return
                f = int(req.get("video_length", args.video_length))
                steps = int(req.get("num_inference_steps", args.num_inference_steps))
                guidance = float(req.get("guidance_scale", 8.0))
                seed = int(req.get("seed", args.seed))
                camera = None
                if req.get("camera_txt"):
                    # validated here, parsed once: a trajectory whose length disagrees
                    # with video_length would fail inside the batched call and answer
                    # 500 to every request coalesced with it
                    try:
                        camera = parse_camera_text(req["camera_txt"])
                    except (ValueError, IndexError) as e:
                        self._json(400, {"error": f"bad camera_txt: {e}"})
                        return
                    if len(camera[1]) != f:
                        self._json(400, {"error": f"camera_txt has {len(camera[1])} poses "
                                                  f"but video_length={f}"})
                        return
                t0 = time.time()
                video = batcher.submit(Job(prompts=prompts, seed=seed, camera=camera,
                                           video_length=f, steps=steps, guidance=guidance))
                t_gif = time.perf_counter()
                data = videos_grid_gif(video)
                t_gif = time.perf_counter() - t_gif
                peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                        if dev.type == "cuda" else "")
                print(f"# serve: generated {len(prompts)} clip(s) x {f}f in "
                      f"{time.time() - t0:.3f}s (gif {t_gif * 1e3:.1f} ms, {len(data)} "
                      f"bytes{peak})", flush=True)
                self.send_response(200)
                self.send_header("Content-Type", "image/gif")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except Exception as e:  # answer with the error and keep serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None) -> int:
    args = parse_args(argv)
    from http.server import ThreadingHTTPServer

    from synfmc_tpu_torch.pipelines.factory import build_pipeline
    from synfmc_tpu_torch.scripts.generate import camera_plucker
    from synfmc_tpu_torch.serving.batcher import MicroBatcher

    t0 = time.time()
    pipe, info = build_pipeline(
        args.config, seed=args.seed, video_length=args.video_length,
        lora_ckpt=args.lora_ckpt, cm_ckpt=args.cm_ckpt, omcm_ckpt=args.omcm_ckpt,
        allow_untrained_cm=args.allow_untrained_cm, device="cpu" if args.cpu else None)
    print(f"# serve: pipeline ({info['stage']} stage) loaded on {pipe.device} in "
          f"{time.time() - t0:.1f}s", flush=True)
    if args.warmup:
        t0 = time.time()
        h, w = info["sample_size"]
        pipe(["warmup"], video_length=args.video_length, height=h, width=w,
             num_inference_steps=args.num_inference_steps,
             generator=torch.Generator(device=pipe.device).manual_seed(0),
             plucker=camera_plucker((h, w), 1, args.video_length, None, pipe.device),
             deepcache_interval=args.deepcache, cfg_cache_interval=args.cfg_cache,
             solver=args.solver, decode_chunk=args.decode_chunk)
        print(f"# serve: warmup done in {time.time() - t0:.1f}s", flush=True)

    batcher = MicroBatcher(make_run_group(args, pipe, info), max_batch=args.max_batch,
                           batch_window=args.batch_window)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(args, pipe, info, batcher))
    print(f"# serve: listening on {args.host}:{server.server_address[1]} "
          f"(stage={info['stage']})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
