#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (synfmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each raising on failure (non-zero exit):
  1. device   - needs CUDA; prints the card's name and power limit;
  2. build    - compiles every CUDA kernel from synfmc_tpu_torch/csrc/;
  3. kernels  - each kernel at every shape the main path gives it (recorded
                from one full-width forward) against its plain PyTorch version
                on the same bf16 inputs (max abs error < 0.05 and < 2**-6 of
                the plain output's largest magnitude) plus one fp32 case each
                (< 1e-4, TF32 off), with kernel, plain, library (one PyTorch
                call) and bound times;
  4. compose  - the tiny-width pipeline in fp32 on the GPU (kernels) and on
                the CPU (plain versions) with the same weights: final
                latents within 1e-3;
  5. main     - the flagship cam-stage pipeline of configs/cam.yaml in bf16
                with seeded random weights answers two requests (16 frames,
                256x384, guidance 8, 4 DDIM steps, decode) with launch
                counters checked.
``--profile`` adds a torch.profiler trace of one request's denoise loop: device
time by kernel family per step and the device's idle share.  The last two
lines of stdout are the kernels' JSON summary and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

BF16_TOL = 0.05  # outer cap: bench.py:verify_kernels_on_device forward bound
# bf16 limit relative to the plain output's largest magnitude.  Rounding the
# output to bf16 alone costs up to 2**-8 of it; 2**-6 leaves room for the few
# roundings inside a kernel (scaled q, P before PV) and still fails a kernel
# whose output is wrong by a few percent.
BF16_REL_TOL = 2 ** -6
F32_TOL = 1e-4
LATENT_TOL = 1e-3

# Data-sheet rates per H100 form (dense; NVIDIA data sheets).
RATES = {
    "SXM": dict(bf16=989e12, f32=67e12, bytes=3.35e12),
    "PCIe": dict(bf16=756e12, f32=51e12, bytes=2.0e12),
    "NVL": dict(bf16=835e12, f32=60e12, bytes=3.9e12),
}

REPO = os.path.dirname(os.path.abspath(__file__))
CAM_YAML = os.path.join(REPO, "configs", "cam.yaml")  # the flagship cam stage
# The tiny width of tests/test_torch_slice.py.
TINY_OVERRIDES = {
    "block_out_channels": [32, 64, 128, 128], "cross_attention_dim": 64, "attn_heads": 4,
    "text": {"vocab_size": 49408, "hidden_size": 64, "num_layers": 2, "num_heads": 4},
    "vae_channels": [32, 32, 64, 64],
}

FRAMES, HEIGHT, WIDTH, STEPS, GUIDANCE, OMCM = 16, 256, 384, 4, 8.0, 700
PER_FORWARD = {"flash": 10, "temporal": 41, "group_norm": 81}
PER_REQUEST = {"temporal": 8}   # pose encoder, batch 1
PER_FRAME = {"group_norm": 30}  # VAE decoder


def log(msg: str) -> None:
    print(msg, flush=True)


def rates_for(name: str) -> tuple[str, dict]:
    for form in ("PCIe", "NVL"):
        if form in name:
            return form, RATES[form]
    return "SXM", RATES["SXM"]


def time_ms(fn, arg_sets, reps: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, rotating over fresh input sets."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    events = []
    for i in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        args = arg_sets[i % len(arg_sets)]
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_error(got, want) -> tuple[float, float]:
    """Max abs error of a kernel's output against its plain version, and that
    error relative to the plain output's largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def bf16_ok(err: float, rel: float) -> bool:
    return err < BF16_TOL and rel < BF16_REL_TOL


def camera(kind: str, b: int = 1):
    """Intrinsics as scripts/generate.py builds them ([w, h, 0, 0]); c2w either
    identity or a synthetic pan (translation along x plus a slow yaw)."""
    intr = torch.tensor([WIDTH, HEIGHT, 0.0, 0.0]).expand(b, FRAMES, 4).contiguous()
    c2w = torch.eye(4).expand(b, FRAMES, 4, 4).contiguous()
    if kind == "pan":
        s = torch.linspace(0.0, 1.0, FRAMES)
        ang = 0.3 * s
        c2w[..., 0, 0] = c2w[..., 2, 2] = torch.cos(ang)
        c2w[..., 0, 2], c2w[..., 2, 0] = torch.sin(ang), -torch.sin(ang)
        c2w[..., 0, 3] = s
    return intr, c2w


def feature_shapes(chs, b=1):
    h, w = HEIGHT // 8, WIDTH // 8
    return [(b, FRAMES, h // 2 ** i, w // 2 ** i, c) for i, c in enumerate(chs)]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def record_shapes(pipe, chs):
    """One full-width UNet forward on the CFG pair, one pose-encoder call and
    one VAE frame decode with the wrappers' call sites wrapped, to collect
    the shapes and arguments the main path gives each kernel."""
    import synfmc_tpu_torch.ops.attention as attn_mod
    import synfmc_tpu_torch.ops.norms as norms_mod

    seen = {"flash": Counter(), "temporal": Counter(), "group_norm": Counter()}
    real = (attn_mod.flash_attention, attn_mod.temporal_attention, norms_mod.fused_group_norm)

    def flash(q, k, v, scale, heads):
        seen["flash"][(stage[0],) + tuple(q.shape) + (heads, scale)] += 1
        return real[0](q, k, v, scale, heads)

    def temporal(q, k, v, scale, heads):
        seen["temporal"][(stage[0],) + tuple(q.shape) + (heads, scale)] += 1
        return real[1](q, k, v, scale, heads)

    def gn(x, scale, bias, num_groups, eps=1e-5, act=None):
        n, c = x.shape[0], x.shape[-1]
        seen["group_norm"][(stage[0], n, x.numel() // (n * c), c, num_groups, eps, act)] += 1
        return real[2](x, scale, bias, num_groups, eps=eps, act=act)

    stage = ["pose"]
    attn_mod.flash_attention, attn_mod.temporal_attention, norms_mod.fused_group_norm = (
        flash, temporal, gn)
    try:
        from synfmc_tpu_torch.geometry.plucker import plucker_embedding

        dev, dt = pipe.device, pipe.unet.dtype
        with torch.inference_mode():
            intr, c2w = camera("pan")
            pose = pipe.encode_pose(plucker_embedding(intr.to(dev), c2w.to(dev), HEIGHT, WIDTH))
            stage[0] = "unet"
            lat = torch.randn(2, FRAMES, HEIGHT // 8, WIDTH // 8, 4, device=dev)
            ctx = torch.randn(2, 77, 768, device=dev, dtype=dt)
            pose2 = [torch.cat([p, p]) for p in pose]
            traj = [torch.randn(s, device=dev, dtype=dt) for s in feature_shapes(chs, 2)]
            pipe.unet(lat, torch.full((2,), 751, device=dev), ctx, pose_features=pose2,
                      traj_features=traj)
            stage[0] = "vae"
            pipe.vae.decode(lat[:1, 0])
        torch.cuda.synchronize()
    finally:
        attn_mod.flash_attention, attn_mod.temporal_attention, norms_mod.fused_group_norm = real
    return seen


def kernel_case(kind, key, dtype, gen):
    """(kernel fn, plain fn, library fn, input sets, flops, bytes, flop rate key)."""
    from synfmc_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm, group_norm_plain
    from synfmc_tpu_torch.ops.temporal_attention import (
        temporal_attention,
        temporal_attention_plain,
    )

    esize = torch.finfo(dtype).bits // 8
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    if kind in ("flash", "temporal"):
        _, b, s, c, heads, scale = key
        d = c // heads
        sets = [tuple(rnd(b, s, c) for _ in range(3)) for _ in range(2)]
        view = lambda x: x.view(b, s, heads, d).transpose(1, 2)
        kern, plain = ((flash_attention, flash_attention_plain) if kind == "flash"
                       else (temporal_attention, temporal_attention_plain))
        return (lambda q, k, v: kern(q, k, v, scale, heads),
                lambda q, k, v: plain(q, k, v, scale, heads),
                lambda q, k, v: F.scaled_dot_product_attention(view(q), view(k), view(v),
                                                               scale=scale),
                sets, 4.0 * b * heads * s * s * d, 4.0 * b * s * c * esize, "bf16")
    _, n, s, c, groups, eps, act = key
    # unit-scale activations and near-identity affine, as in a trained model:
    # outputs stay O(1), where bf16's half-ulp is below 0.016
    sets = []
    for _ in range(2):
        x = rnd(n, s, c)
        sets.append((x, (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype),
                     (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)))

    def library(x, w, b):
        # (N, S, C) seen as a channels-last (N, C, S, 1) tensor: no copy
        y = F.group_norm(x.transpose(1, 2).unsqueeze(-1), groups, w.to(x.dtype),
                         b.to(x.dtype), eps)
        return F.silu(y) if act == "silu" else (F.relu(y) if act == "relu" else y)

    ops = (9 if act == "silu" else 5) * n * s * c
    return (lambda x, w, b: fused_group_norm(x, w, b, groups, eps, act),
            lambda x, w, b: group_norm_plain(x, w, b, groups, eps, act),
            library, sets, float(ops), 2.0 * n * s * c * esize, "f32")


def check_kernels(seen, rates):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {k: [] for k in seen}
    for kind, keys in seen.items():
        for key, count in sorted(keys.items(), key=lambda kv: str(kv[0])):
            kern, plain, lib, sets, flops, nbytes, rate = kernel_case(kind, key, torch.bfloat16, gen)
            want = plain(*(x.float() for x in sets[0]))
            err, rel = kernel_error(kern(*sets[0]), want)
            torch.cuda.synchronize()
            if not bf16_ok(err, rel):
                raise AssertionError(f"{kind} {key}: bf16 max abs err {err} (limit {BF16_TOL}), "
                                     f"{rel} of the largest output (limit {BF16_REL_TOL})")
            t_ops, t_bytes = flops / rates[rate] * 1e3, nbytes / rates["bytes"] * 1e3
            row = dict(key=key, per_forward=count, err=err, rel=rel, ms=time_ms(kern, sets),
                       plain_ms=time_ms(plain, sets, reps=5, warmup=1),
                       library_ms=time_ms(lib, sets), bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops > t_bytes else "bytes")
            results[kind].append(row)
            log(f"  {kind:10s} {str(key[:-2] if kind != 'group_norm' else key):60s} "
                f"x{count:3d} err={err:.2e} rel={rel:.2e} ms={row['ms']:.4f} "
                f"plain={row['plain_ms']:.4f} lib={row['library_ms']:.4f} bound={row['bound_ms']:.4f} ({row['bound_by']})")
    # one fp32 case per kernel, TF32 off everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kind, key in (("flash", ("unet", 2, 384, 640, 8, 80 ** -0.5)),
                      ("temporal", ("unet", 768, 16, 640, 8, 80 ** -0.5)),
                      ("group_norm", ("unet", 32, 384, 640, 32, 1e-6, "silu"))):
        kern, plain, _, sets, *_ = kernel_case(kind, key, torch.float32, gen)
        err = (kern(*sets[0]) - plain(*sets[0])).abs().max().item()
        if not err < F32_TOL:
            raise AssertionError(f"{kind} {key}: fp32 max abs err {err} >= {F32_TOL}")
        log(f"  {kind:10s} fp32 {key[1:4]} err={err:.2e}")
    return results


# ---------------------------------------------------------------------------
# phase 4: composition at tiny width, GPU kernels against CPU plain versions
# ---------------------------------------------------------------------------


def compose():
    from synfmc_tpu_torch.geometry.plucker import plucker_embedding
    from synfmc_tpu_torch.pipelines.animation import decode_latents
    from synfmc_tpu_torch.pipelines.factory import build_pipeline, load_config

    cfg = load_config(CAM_YAML)
    cfg["model_overrides"] = TINY_OVERRIDES
    cfg["unet_additional_kwargs"]["motion_module_kwargs"]["num_attention_heads"] = 4
    cfg["pose_encoder_kwargs"]["temporal_attention_nhead"] = 4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_pipeline(cfg, device="cpu", dtype=torch.float32, seed=0)
    gpu = build_pipeline(cfg, device="cuda", dtype=torch.float32, seed=1)
    for name in ("unet", "vae", "text_encoder", "pose_encoder"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    rng = np.random.default_rng(7)
    latents = torch.from_numpy(rng.normal(size=(1, FRAMES, HEIGHT // 8, WIDTH // 8, 4))
                               .astype(np.float32))
    traj = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3)
            for s in feature_shapes(TINY_OVERRIDES["block_out_channels"])]
    intr, c2w = camera("pan")
    out = {}
    for name, pipe in (("gpu", gpu), ("cpu", cpu)):
        dev = pipe.device
        t0 = time.perf_counter()
        lat = pipe(["a knight marches across a field"], latents=latents.to(dev),
                   plucker=plucker_embedding(intr.to(dev), c2w.to(dev), HEIGHT, WIDTH),
                   traj_features=[t.to(dev) for t in traj], num_inference_steps=2,
                   guidance_scale=GUIDANCE, omcm_min_step=300, decode=False)
        img = decode_latents(pipe.vae, lat)
        out[name] = (lat.cpu(), img.cpu())
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    lat_err = (out["gpu"][0] - out["cpu"][0]).abs().max().item()
    img_err = (out["gpu"][1] - out["cpu"][1]).abs().max().item()
    log(f"  latents max abs err {lat_err:.3e} (limit {LATENT_TOL}), images {img_err:.3e}")
    if not lat_err < LATENT_TOL:
        raise AssertionError(f"composition: latents differ by {lat_err}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return lat_err, img_err


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------


def counters():
    from synfmc_tpu_torch.ops.flash_attention import flash_attention
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm
    from synfmc_tpu_torch.ops.temporal_attention import temporal_attention

    return {"flash": flash_attention, "temporal": temporal_attention,
            "group_norm": fused_group_norm}


def serve(pipe, chs):
    from synfmc_tpu_torch.geometry.plucker import plucker_embedding

    requests = [("a knight marches across a field", "identity"),
                ("a blue dragon soars, seen from behind", "pan")]
    expect = {k: PER_FORWARD[k] * STEPS + PER_REQUEST.get(k, 0) + PER_FRAME.get(k, 0) * FRAMES
              for k in PER_FORWARD}
    dev, dt = pipe.device, pipe.unet.dtype
    launches = Counter()
    step_ms, clip_s = [], []
    for i, (prompt, cam) in enumerate(requests):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        traj = [torch.randn(s, generator=gen, device=dev).to(dt) * 0.1
                for s in feature_shapes(chs)]
        intr, c2w = camera(cam)
        events = []

        def on_step(idx, t):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        video = pipe(prompt, video_length=FRAMES, height=HEIGHT, width=WIDTH,
                     num_inference_steps=STEPS, guidance_scale=GUIDANCE, generator=gen,
                     plucker=plucker_embedding(intr.to(dev), c2w.to(dev), HEIGHT, WIDTH),
                     traj_features=traj, omcm_min_step=OMCM, on_step=on_step)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
        got = {k: fn.launches for k, fn in counters().items()}
        if got != expect:
            raise AssertionError(f"request {i}: launches {got} != expected {expect}")
        launches.update(got)
        if tuple(video.shape) != (1, FRAMES, HEIGHT, WIDTH, 3):
            raise AssertionError(f"request {i}: output shape {tuple(video.shape)}")
        if not bool(torch.isfinite(video).all()) or video.min() < 0 or video.max() > 1:
            raise AssertionError(f"request {i}: output not finite in [0, 1]")
        steps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        step_ms += steps
        log(f"  request {i} ({cam}): {clip_s[-1]:.2f} s/clip, steps {['%.1f' % s for s in steps]} ms, "
            f"launches {got}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"mean pixel {video.float().mean().item():.4f}")
    return launches, statistics.median(step_ms), clip_s, torch.cuda.max_memory_allocated()


def profile_loop(pipe, chs) -> dict:
    """One request's denoise loop (STEPS CFG steps), once untraced and once
    under torch.profiler with CUDA activity only: device time per step by
    kernel family, and the device's idle share over the traced loop (1 - the
    union of device intervals over the span from the first one's start to the
    last one's end).  The tracer adds host time per launch, so the traced
    idle share is an upper bound; the untraced loop's step time is beside it."""
    from torch.profiler import ProfilerActivity, profile

    from synfmc_tpu_torch.geometry.plucker import plucker_embedding
    from synfmc_tpu_torch.pipelines.animation import denoise_loop

    dev, dt = pipe.device, pipe.unet.dtype
    gen = torch.Generator(device=dev).manual_seed(7)
    intr, c2w = camera("pan")
    context = pipe.encode_prompt("a knight marches across a field")
    pose = pipe.encode_pose(plucker_embedding(intr.to(dev), c2w.to(dev), HEIGHT, WIDTH))
    traj = [torch.randn(s, generator=gen, device=dev).to(dt) * 0.1 for s in feature_shapes(chs)]
    lat = torch.randn(1, FRAMES, HEIGHT // 8, WIDTH // 8, 4, generator=gen, device=dev)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        denoise_loop(pipe.unet, pipe.schedule, lat, context, pose_features=pose,
                     traj_features=traj, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                     omcm_min_step=OMCM)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    run()
    untraced_ms = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_ms = run()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, spans[0][0]
    for start, end, _ in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    families = Counter()
    for start, end, n in spans:
        n = n.lower()
        if "flash_fwd" in n:
            fam = "K1 flash_fwd"
        elif "temporal_fwd" in n:
            fam = "K2 temporal_fwd"
        elif any(k in n for k in ("gn_stats", "gn_finalize", "gn_apply")):
            fam = "K3 group_norm"
        elif any(k in n for k in ("fprop", "conv", "dgrad", "cudnn")):
            fam = "conv (cuDNN)"
        elif any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma")):
            fam = "gemm (cuBLAS)"
        elif any(k in n for k in ("copy", "cat", "permute", "transpose", "memcpy", "memset")):
            fam = "copy/cat"
        elif "softmax" in n or "reduce" in n:
            fam = "softmax/reduce"
        else:
            fam = "other elementwise"
        families[fam] += (end - start) / 1e3 / STEPS
    busy_ms = busy_us / 1e3 / STEPS
    out = {"steps": STEPS, "untraced_ms_per_step": untraced_ms, "traced_ms_per_step": traced_ms,
           "device_busy_ms_per_step": busy_ms, "kernels_per_step": len(spans) / STEPS,
           "idle_share_traced": 1 - busy_us / (spans[-1][1] - spans[0][0]),
           "idle_share_estimate_untraced": 1 - busy_ms / untraced_ms,
           "families_ms_per_step": {k: round(v, 3) for k, v in families.most_common()}}
    log(f"[profile] denoise loop of one request: {json.dumps(out)}")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                  max_name_column_width=60))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from synfmc_tpu_torch.ops import _cuda
    from synfmc_tpu_torch.pipelines.factory import build_pipeline

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    form, rates = rates_for(name)
    log(f"[device] {name} (rates of the H100 {form}: {rates}); torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi[0] if smi else "nvidia-smi: no output")

    t0 = time.perf_counter()
    logs = _cuda.build_all()
    for src, text in logs.items():
        info = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {src}: " + " | ".join(info[:6]))
    for src in _cuda.SOURCES:
        _cuda.load(src)
    log(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pipe = build_pipeline(CAM_YAML, seed=0)
    chs = pipe.unet.block_out_channels
    log(f"[main] flagship cam-stage pipeline built in {time.perf_counter() - t0:.1f} s, "
        f"UNet {sum(p.numel() for p in pipe.unet.parameters()) / 1e6:.0f} M params, {pipe.unet.dtype}")

    log("[kernels] shapes recorded from one full-width forward")
    seen = record_shapes(pipe, chs)
    per_forward = {k: sum(n for key, n in v.items() if key[0] == "unet") for k, v in seen.items()}
    if per_forward != PER_FORWARD:
        raise AssertionError(f"per-forward launches {per_forward} != {PER_FORWARD}")
    results = check_kernels(seen, rates)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("[compose] tiny width, 16 frames at 256x384, 2 DDIM steps, fp32: GPU vs CPU")
    compose()

    log(f"[main] two requests: {FRAMES} frames {HEIGHT}x{WIDTH}, {STEPS} DDIM steps, guidance {GUIDANCE}")
    launches, step_ms, clip_s, peak = serve(pipe, chs)
    log(f"[main] {step_ms:.2f} ms per CFG denoise step (median), "
        f"{statistics.mean(clip_s):.2f} s per clip, peak {peak / 2**30:.2f} GiB")

    if "--profile" in sys.argv[1:]:
        profile_loop(pipe, chs)

    meta = {
        "flash": ("synfmc_tpu_torch/csrc/flash_fwd.cu", "synfmc_tpu/ops/flash_attention.py:117"),
        "temporal": ("synfmc_tpu_torch/csrc/temporal_fwd.cu",
                     "synfmc_tpu/ops/temporal_attention.py:75"),
        "group_norm": ("synfmc_tpu_torch/csrc/group_norm.cu",
                       "synfmc_tpu/ops/pallas_groupnorm.py:58"),
    }
    summary = []
    for kind, rows in results.items():
        hot = max(rows, key=lambda r: r["per_forward"] * r["ms"])
        summary.append({
            "name": kind, "route": "cuda", "source": meta[kind][0], "replaces": meta[kind][1],
            "launches": launches[kind], "max_abs_err": max(r["err"] for r in rows),
            "max_rel_err": max(r["rel"] for r in rows),
            "ms": hot["ms"], "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
            "bound_by": hot["bound_by"], "library_ms": hot["library_ms"],
            "shape": list(hot["key"][1:]),
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
