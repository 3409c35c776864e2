"""Ahead-of-time serving export: the whole generation program as one
``torch.export`` artifact.

The port of scripts/export_serving.py.  It packages the serving path -- CLIP
text encode, camera pose encode, the CFG denoise loop in the asked mode
(DDIM or DPM-Solver++(2M), DeepCache, CFG-cache), the frame-wise VAE decode
-- as one ``ExportedProgram`` written by ``torch.export.save``:

    serve(input_ids (2B, 77) int64, latents (B, F, H/8, W/8, 4) fp32,
          plucker (B, F, H, W, 6) fp32) -> frames (B, F, H, W, 3) in [0, 1]

The CUDA kernels appear in the graph as the ``torch.ops.synfmc.*`` ops, so the
process that loads the artifact imports ``synfmc_tpu_torch.ops`` first (that
import registers them), then calls ``torch.export.load(path).module()``.  The
weights travel in the artifact and can be replaced with ``load_state_dict`` on
the loaded module: one artifact serves every fine-tune of the same shapes.
The step loop is unrolled and each mode's per-step branches are fixed at
export time; the decode takes every frame in one VAE call (the VAE is
frame-independent, so the frames are those of a frame-by-frame decode).

    # export (tiny, on the CPU)
    python -m synfmc_tpu_torch.scripts.export_serving --tiny --cpu --out /tmp/fmc_serve.pt2

    # verify: load the artifact and hold it to the live program
    python -m synfmc_tpu_torch.scripts.export_serving --tiny --cpu --out /tmp/fmc_serve.pt2 --verify

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

TINY = dict(
    block_out_channels=[32, 64, 128, 128], cross_attention_dim=32, attn_heads=4,
    vae_channels=[32, 32, 32, 32],
    text=dict(vocab_size=49408, hidden_size=32, num_layers=1, num_heads=2),
)
VERIFY_TOL = 1e-4
SWAP_SEED = 1


class ServingProgram(torch.nn.Module):
    """Text encode, pose encode, the denoise loop and the decode as one
    module, the modes fixed at construction."""

    def __init__(self, models: dict, schedule, num_inference_steps: int,
                 guidance_scale: float = 8.0, deepcache_interval: int = 1,
                 cfg_cache_interval: int = 1, solver: str = "ddim"):
        super().__init__()
        from synfmc_tpu_torch.pipelines.animation import check_modes

        check_modes(1, deepcache_interval, cfg_cache_interval, solver, False)
        self.unet, self.vae = models["unet"], models["vae"]
        self.text, self.pose_encoder = models["text"], models["pose_encoder"]
        self.schedule = schedule
        self.modes = dict(num_inference_steps=num_inference_steps,
                          guidance_scale=guidance_scale, deepcache_interval=deepcache_interval,
                          cfg_cache_interval=cfg_cache_interval, solver=solver)

    def forward(self, input_ids, latents, plucker):
        from synfmc_tpu_torch.pipelines.animation import decode_latents, denoise_loop

        context = self.text(input_ids)
        pose_features = self.pose_encoder(plucker)
        # the loops without their inference_mode decorators: a trace runs under no_grad
        lat = denoise_loop.__wrapped__(self.unet, self.schedule, latents, context,
                                       pose_features=pose_features, **self.modes)
        # every frame in one VAE call: a frame-by-frame decode would unroll in the graph
        return decode_latents.__wrapped__(self.vae, lat, decode_chunk=lat.shape[0] * lat.shape[1])


def build_program(args, device) -> tuple[ServingProgram, dict]:
    """The cam-stage models as the JAX script builds them (seeded weights with
    the structural zeros; fp32 with ``--tiny``, else bf16 at full width) in a
    ServingProgram, and the shapes."""
    from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
    from synfmc_tpu_torch.pipelines.factory import cast_models_, init_models

    h = args.height or (64 if args.tiny else 256)
    w = args.width or (128 if args.tiny else 384)
    f = args.frames or (4 if args.tiny else 16)
    steps = args.num_inference_steps or (2 if args.tiny else 25)
    cfg = {"unet_additional_kwargs": {"use_motion_module": True}}
    if args.tiny:
        cfg["model_overrides"] = TINY
    models = init_models(cfg, "cam", 0, device)
    cast_models_(models, torch.float32 if args.tiny else torch.bfloat16)
    program = ServingProgram(models, DiffusionSchedule.from_config(), steps,
                             args.guidance_scale, args.deepcache, args.cfg_cache,
                             args.solver).eval()
    return program, dict(height=h, width=w, frames=f, num_inference_steps=steps)


def sample_inputs(shapes: dict, device, batch: int = 1, seed=None) -> tuple:
    """(input_ids, latents, plucker): zeros (the export's example inputs), or
    with ``seed`` the verify inputs (ones, seeded noise scaled by the
    schedule's init sigma, seeded Plücker rays scaled by 0.1)."""
    f, h, w = shapes["frames"], shapes["height"], shapes["width"]
    lat_shape, plk_shape = (batch, f, h // 8, w // 8, 4), (batch, f, h, w, 6)
    if seed is None:
        return (torch.zeros((2 * batch, 77), dtype=torch.int64, device=device),
                torch.zeros(lat_shape, device=device), torch.zeros(plk_shape, device=device))
    gen = torch.Generator().manual_seed(seed)
    lat = torch.randn(lat_shape, generator=gen)  # init_noise_sigma is 1.0 for DDIM
    plk = torch.randn(plk_shape, generator=gen) * 0.1
    return (torch.ones((2 * batch, 77), dtype=torch.int64, device=device), lat.to(device),
            plk.to(device))


def export_program(program: ServingProgram, example: tuple):
    """``torch.export.export`` of the program under no_grad."""
    with torch.no_grad():
        return torch.export.export(program, example)


def parameter_count(ep) -> int:
    names = set(ep.graph_signature.parameters)
    return sum(t.numel() for k, t in ep.state_dict.items() if k in names)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def verify(program: ServingProgram, path: str, shapes: dict, device) -> tuple[dict, torch.nn.Module]:
    """Load the artifact in this process and run it against the live program
    on the verify inputs; then load a second seeded weight set into both (the
    loaded module by ``load_state_dict(strict=True)``) and compare again.
    Returns the report's verify keys and the loaded module."""
    from synfmc_tpu_torch.pipelines.factory import init_random_

    import synfmc_tpu_torch.ops  # noqa: F401  (registers torch.ops.synfmc)

    t0 = time.perf_counter()
    loaded = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    inputs = sample_inputs(shapes, device, seed=7)
    with torch.no_grad():
        got = loaded(*inputs)
        want = program(*inputs)
        err = max_err(got, want)
        finite = bool(torch.isfinite(got).all())
        gen = torch.Generator(device=device).manual_seed(SWAP_SEED)
        for module in (program.unet, program.vae, program.text, program.pose_encoder):
            init_random_(module, gen)
        loaded.load_state_dict(program.state_dict(), strict=True)
        got2 = loaded(*inputs)
        want2 = program(*inputs)
        err2 = max_err(got2, want2)
        finite = finite and bool(torch.isfinite(got2).all())
    return dict(verify_max_err=err, verify_swap_max_err=err2, verify_load_s=load_s,
                verify_swap_changed=max_err(got2, got),
                verify_ok=bool(err < VERIFY_TOL and err2 < VERIFY_TOL and finite)), loaded


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m synfmc_tpu_torch.scripts.export_serving",
        description="Export the serving program (text encode, pose encode, the denoise loop, "
                    "the decode) with torch.export.",
        epilog="The JAX script's --platforms has no counterpart: an exported program runs on "
               "the device it was exported for (the card, or the CPU with --cpu).  Loading "
               "an artifact needs `import synfmc_tpu_torch.ops` first.")
    p.add_argument("--out", required=True)
    p.add_argument("--tiny", action="store_true", help="tiny widths in fp32 (tests)")
    p.add_argument("--cpu", action="store_true", help="export for the CPU (plain versions)")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--num-inference-steps", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=8.0)
    p.add_argument("--deepcache", type=int, default=1)
    p.add_argument("--cfg-cache", type=int, default=1)
    p.add_argument("--solver", choices=("ddim", "dpmpp_2m"), default="ddim")
    p.add_argument("--verify", action="store_true",
                   help="load the artifact and check it matches the live program")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from synfmc_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    program, shapes = build_program(args, device)
    t0 = time.perf_counter()
    ep = export_program(program, sample_inputs(shapes, device))
    export_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    torch.export.save(ep, args.out)
    save_s = time.perf_counter() - t0
    report = {
        "out": args.out, "bytes": os.path.getsize(args.out), "platforms": [device.type],
        "in_avals": len(ep.graph_signature.input_specs), "parameters": parameter_count(ep),
        **shapes, "deepcache_interval": args.deepcache, "cfg_cache_interval": args.cfg_cache,
        "solver": args.solver, "export_s": export_s, "save_s": save_s,
    }
    del ep
    if args.verify:
        report.update(verify(program, args.out, shapes, device)[0])
    print(json.dumps(report), flush=True)
    return 1 if args.verify and not report["verify_ok"] else 0


if __name__ == "__main__":
    sys.exit(main())
