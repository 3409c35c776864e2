#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (synfmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --train-files
    python3 chip_smoke.py --train-stages
    python3 chip_smoke.py --tools
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --passes [ROOT]

Phases, each raising on failure (non-zero exit):
  1. device   - needs CUDA; prints the card's name and power limit;
  2. build    - compiles every CUDA kernel from synfmc_tpu_torch/csrc/;
  3. kernels  - each forward kernel at every shape the serving modes give it
                (recorded from a full-width UNet forward on the CFG pair, one
                at batch 1 as a CFG-cache step runs it, a DeepCache shallow
                forward, the pose encoder, the ObjectAdapter, a frame decode
                and a 4-frame decode, and the serve daemon's group of two
                requests (pose encoder at batch 2, UNet at batch 4), each
                stage's launches checked), and K1
                at the padded stand-in shape
                2x1617x(8x40) (K4's case), against its plain PyTorch version
                on the same bf16 inputs (max abs error < 0.05 and < 2**-6 of
                the plain output's largest magnitude) plus one fp32 case each
                (< 1e-4, TF32 off), with kernel, plain, library (one PyTorch
                call) and bound times; kernel and library times are taken
                with the device idle at each call (host launch cost
                included) and again as device time only (`device_ms`,
                `library_device_ms`); K3's fused SiLU over v in [-20, 20]
                against v * sigmoid(v) (bf16 within one unit in the last
                place, fp32 within 2**-16 relative);
  4. compose  - the tiny-width obj-stage pipeline in fp32 on the GPU (kernels)
                and on the CPU (plain versions) with the same weights and
                inputs: one OMC request (8 frames at 256x384) with traj
                features from a raster
                through the ObjectAdapter, then DPM-Solver++(2M), DeepCache,
                CFG-cache, turbo + DPM++ and multidiff windows with a chunked
                decode: final latents (and the chunked decode's frames)
                within 1e-3;
  5. train-compose - the tiny-width stage-2 train step in fp32 on the GPU and
                on the CPU with the same weights, batches and draws: loss
                within 1e-5 relative, every trainable gradient within 1e-3 of
                its largest magnitude, parameters after 2 AdamW steps within
                2 lr;
  6. main     - the flagship obj-stage pipeline of configs/obj.yaml in bf16
                with seeded random weights answers five requests (16-frame
                windows at 256x384, guidance 8, 4 steps, decode; REQUESTS):
                exact DDIM and DPM++ with turbo, both with traj features made
                from seeded objects with sphere masks through the rasterizer
                and the ObjectAdapter, DeepCache and CFG-cache with a camera,
                and 2 multidiff windows (20 frames) decoded 4 frames a call;
                each request's UNet forwards by kind and its launch counters
                are checked exactly; ms per step, s/clip, peak per mode;
                then the host cost of reaching K1-K3 through their
                registered ops (torch.ops.synfmc.*) against a direct call of
                the same implementation, at request (a)'s most frequent key
                of each, times its launches a step, beside (a)'s ms per step;
  7. train    - training.trainers.train("cam", configs/cam.yaml) at full
                width (batch 1, 16x256x384, bf16, fp32 masters) takes 5 AdamW
                steps on seeded synthetic batches: finite losses, a finite
                non-zero gradient for every trainable tensor at the first
                step after step 1 that kept the camera,
                trainable weights moved and frozen ones not, launch counters
                exact per step; ms per step, peak memory, trainable count;
  8. backward - every kernel at every shape the recorded train steps gave it
                (forward kernels at the train shapes; the backward kernels K5
                and K8 gradient by gradient: abs < 1.0, < 2**-6 of the plain
                gradient's largest magnitude), the flash backward at the
                stand-in shapes of K6 (2x6144x(8x40)) and K7 (2x1617x(8x40)),
                one fp32 case each (< 1e-4 of the largest magnitude), times
                against the bound, the plain version and SDPA's backward, the
                GroupNorm backward (PyTorch ops, not a kernel) timed, and the
                flash backward's passes (prologue, dK/dV, dQ) by device time
                at the train step's spatial keys, level 0 first.
  9. train-files - `python -m synfmc_tpu_torch.scripts.train --stage cam` as
                child processes at full width (batch 1, 16x256x384, bf16, fp32
                masters, 8 loader workers) on a fixture dataset (4 sequences x
                65 frames at 512x768, 3 objects) and the serving phase's
                weights as reference-layout SD1.5 / motion-module / LoRA files,
                checkpointing every 2 steps: 4 steps; 2 steps, then
                resume_from: auto to 4.  The files' tensors reach the model bit
                for bit, launches per step exact, run c's restored state equal
                to run b's saved one bit for bit, losses after the resume
                within 1e-2 relative of run a's, run a's last cmcm-step-6.ckpt
                through build_pipeline equal to its final weights; first-step
                seconds, data wait and step ms, each checkpoint's path (a
                device snapshot the writer copies to the host, or a host
                copy in the loop), seconds and bytes, peak; then `python -m synfmc_tpu_torch.scripts.validate_dataset`
                on the fixture's config: exit 0;
 10. train-stages - the three stages chained as a user runs them, on the
                same files: first, in process with seeded weights, one
                stage-1 step (configs/lora.yaml: 16 single frames 256x384),
                a stage-1 validation render (one prompt, F = 1, the CFG
                pair) and one stage-3 step (configs/obj.yaml), recorded:
                launches exact (LORA_PER_STEP, OBJ_PER_STEP), a finite
                non-zero gradient for every trainable tensor (the
                ObjectAdapter's last stage zero: it reaches no loss), and
                every kernel at each recorded shape no earlier phase held,
                against its plain version as in phases 3 and 8; then
                `python -m synfmc_tpu_torch.scripts.train` child processes:
                stage 1 on a 16-sequence fixture (4 steps, validation at
                step 2) -> stage 2 loading its lora-step-4.ckpt (3 steps)
                -> stage 3 loading that cmcm-step-3.ckpt (4 steps,
                validation at step 2: the GIFs, masks and camera labels)
                -> stage 3 resumed from its step-2 state to 4 (losses and
                final state equal bit for bit); then stage 3 in process
                with gradient_accumulation_steps 2 and remat "full" and
                "dots" (3 steps each).  On stage 3's validation output, `python
                -m synfmc_tpu_torch.scripts.evaluate --samples-dir`: finite
                RotErr and TransErr for every label pair; `--video-a
                cm-0.gif --video-b real-0.gif`: a finite PSNR; decode_gif of
                each GIF: the frame count and size of its blocks; the FID of
                the rendered GIFs against the real one through a seeded
                TorchScript extractor, card against CPU (fp32, TF32 off):
                features within 1e-4, FID within 1e-3 relative.  Launches per
                step exact in every run (remat's recompute counted), frozen
                weights unchanged,
                each loaded bundle named in the next stage's log, no failed
                validation; ms per step, ms per optimizer step with
                accumulation, peaks with and without remat, first-step
                seconds, checkpoint bytes, validation seconds;
 mesh.        - the multi-GPU path on the one card, as `python -m
                torch.distributed.run` children of this script
                (`--mesh-child`): (a) NCCL at world size 1: `generate
                --data-parallel 1` on request (a)'s shape (a seeded OMC
                bundle, a pan camera file, seeded objects) against the same
                command in this process, and 2 `train("cam")` steps with
                `mesh: {data: 1}` against phase 7's (frames and losses bit
                for bit); (b) 2 ranks over gloo on cuda:0, data-parallel: two
                prompts of request (a)'s shape, each rank's frames against
                its prompt's batch-1 run here bit for bit; (c) 4 ranks, data
                2 x sp 2, request (a) frame-parallel (finite latents, the
                difference from the single run reported), then the tiny fp32
                pipeline in exact + OMC, turbo + DPM++, DeepCache and
                CFG-cache within 1e-3 of the single run, and phase 5's tiny
                step on {fsdp: 2, sp: 2}; (d) 2 ranks: `train("cam")` at full
                width on {data: 2}, {sp: 2}, then {fsdp: 2} (ZeRO-1: the
                first loss bit for bit with phase 7's, the second within
                1e-3, each rank's fp32 masters and moments at most 0.55 of
                {data: 2}'s, the state.pt gathered from the shards cast to
                bf16 equal to the working weights), 2 steps each (replica
                checksums equal bit for bit), and phase 5's tiny step on
                {data: 2}, {sp: 2} and {fsdp: 2} against one process on the
                concatenated batch with phase 5's limits; (e) a SIGTERM on
                rank 1 of a tiny {data: 2} run stops both ranks at the same
                step.  Launches exact per rank everywhere; ms a step a rank,
                bytes the collectives sent, their host seconds and traced
                device ms, peaks.  Ranks that share the card run over gloo
                (NCCL refuses two ranks on one device): the mesh is shown
                right, not its scaling;
 11. entry    - the user's entry points at full width, last: phase 6's
                weights (rebuilt from the same seed) written as
                reference-layout files (an SD1.5 diffusers directory with
                safetensors, a .bin text encoder
                and a BPE tokenizer, an AnimateDiff motion-module checkpoint,
                LoRA / CMC / OMC bundles, a copy of configs/obj.yaml pointing
                at them; ~3.5 GB in a temporary directory, deleted after);
                build_pipeline from them (every parameter equal to its source
                bit for bit); `python -m synfmc_tpu_torch.scripts.generate`
                with a camera file and an object npz (a 16-frame 256x384 GIF
                walked block by block, its launches exact); `python -m
                synfmc_tpu_torch.scripts.serve --port 0 --max-batch 2
                --batch-window 2 --warmup` (/healthz on cuda, two pairs of
                concurrent requests each coalesced into one bucket of 2 with
                exact launches, a wrong-length camera answered 400); the
                command line's token ids and frames against an in-process run
                (frames within 1e-3); load s, s/clip, GIF ms and bytes, peak.
 12. tools    - `python -m synfmc_tpu_torch.scripts.export_serving --verify
                --num-inference-steps 2` at full width (the cam stage,
                16x256x384, bf16) as a child process (torch.export of the
                whole serving program, saved, loaded in the same process and
                held to the live program, then a second seeded weight set
                loaded into both), then the artifact in a fresh process
                (`--tools-load`): its frames against the live eager
                program's within 1e-3, its K1-K3 launches counted by kernel
                name in a trace equal to the eager run's counters; export,
                save and load seconds, bytes, ms a call loaded and eager,
                peaks.
``--profile`` adds a torch.profiler trace of each request's denoise loop and of
one extra train step: device time by kernel family and the device's idle
share.  The last two lines of stdout are the kernels' JSON summary and
{"ok": true, "device": {...}}.

``--train-files`` builds and runs phase 9 alone, ``--train-stages`` phase 10.
``--tools`` runs phase 12, then evaluate, FID and validate_dataset on a
samples directory and a fixture that it writes itself.  ``--mesh`` builds and
runs the mesh phase alone and ends with {"ok": true, ...}.

``--passes [ROOT]`` only times K1 by kernel at its three keys (32x1536x320,
16x1536x320, 32x384x640, 8 heads) beside SDPA's forward kernels, and the
flash backward's passes at the train step's two spatial keys, with the port
package of the tree at ROOT (default: this one), so that two trees compare
in one run.
"""

from __future__ import annotations

import ast
import json
import os
import re
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
# Backward: bench.py's backward bound of 1.0 abs as an outer cap, and each
# gradient's max error under 2**-6 of the plain gradient's largest magnitude.
# The plain backward on bf16 operands (a sound kernel's roundings) stays
# under 0.009 at the train shapes; 2**-5 would pass a dQ 3% high (0.03).
BWD_TOL = 1.0
BWD_REL_TOL = 2 ** -6
F32_TOL = 1e-4
LATENT_TOL = 1e-3

# Data-sheet rates per H100 form (dense; NVIDIA data sheets).
RATES = {
    "SXM": dict(bf16=989e12, f32=67e12, bytes=3.35e12),
    "PCIe": dict(bf16=756e12, f32=51e12, bytes=2.0e12),
    "NVL": dict(bf16=835e12, f32=60e12, bytes=3.9e12),
}
# Exponentials: 16 ex2 a clock per SM (CUDA C++ Programming Guide, throughput
# table, compute capability 9.0) at the card's top SM clock (nvidia-smi's
# clocks.max.sm: 1980 MHz on the H100 SXM); the rate is SMs x 16 x that clock.
EX2_PER_CLOCK = 16

# torch.cuda._sleep spins for a count of SM cycles; at or above the H100's
# top clock (1.98 GHz) the sleep lasts at least the time asked for.
SLEEP_CYCLES_PER_S = 2.0e9

REPO = os.path.dirname(os.path.abspath(__file__))
CAM_YAML = os.path.join(REPO, "configs", "cam.yaml")  # the flagship cam stage
OBJ_YAML = os.path.join(REPO, "configs", "obj.yaml")  # the same UNet with the ObjectAdapter
# The tiny width of tests/test_torch_slice.py.
TINY_OVERRIDES = {
    "block_out_channels": [32, 64, 128, 128], "cross_attention_dim": 64, "attn_heads": 4,
    "text": {"vocab_size": 49408, "hidden_size": 64, "num_layers": 2, "num_heads": 4},
    "vae_channels": [32, 32, 64, 64],
}

FRAMES, HEIGHT, WIDTH, STEPS, GUIDANCE, OMCM = 16, 256, 384, 4, 8.0, 700
# Kernel launches of one UNet forward, the same at batch 2B (the CFG pair)
# and B (a CFG-cache step); of DeepCache's shallow forward (down_blocks[0]
# without its downsampler, up_blocks[3], conv_norm_out: 5 spatial
# transformers, 5 motion modules of 2 temporal attentions, 21 GroupNorms);
# of the pose encoder per request (batch 1); of one VAE decode call, at any
# number of frames.  The ObjectAdapter launches none (convs and ReLUs).
PER_FORWARD = {"flash": 10, "temporal": 41, "group_norm": 81}
PER_SHALLOW = {"flash": 5, "temporal": 10, "group_norm": 21}
PER_REQUEST = {"temporal": 8}
PER_DECODE = {"group_norm": 30}
PER_STAGE = {"unet": PER_FORWARD, "unet_b": PER_FORWARD, "shallow": PER_SHALLOW,
             "pose": PER_REQUEST, "adapter": {}, "vae": PER_DECODE, "vae_chunk": PER_DECODE,
             "pose_2": PER_REQUEST, "unet_2": PER_FORWARD}
# The serve daemon's coalesced group of two requests (phase entry): the pose
# encoder at batch 2 and the UNet on the two CFG pairs at batch 4.  Checked
# like the others; a kernel's summary row is taken from the other stages.
COALESCED = ("pose_2", "unet_2")
DECODE_CHUNK = 4
N_OBJECTS = 3
# The five full-width requests of the obj-stage pipeline: (label, prompt,
# camera or None, objects?, pipeline arguments).  The multidiff request has
# no camera: its 20 frames exceed the pose encoder's 16-position temporal
# encoding (obj.yaml temporal_position_encoding_max_len), which refuses them
# in both packages.
REQUESTS = [
    ("a exact+omc", "a turtle paddles through a coral reef", "pan", True, {}),
    ("b dpmpp+turbo+omc", "a yellow bird hops along the road", "pan", True,
     dict(solver="dpmpp_2m", deepcache_interval=2, cfg_cache_interval=2)),
    ("c deepcache", "a knight marches across a field", "identity", False,
     dict(deepcache_interval=2)),
    ("d cfgcache", "a blue dragon soars, seen from behind", "pan", False,
     dict(cfg_cache_interval=2)),
    ("e multidiff", "a red car drives along a coast road", None, False,
     dict(multidiff_total_steps=2, multidiff_overlaps=12, decode_chunk=DECODE_CHUNK)),
]
# One stage-2 train step at batch 1: the UNet forward (K1 x10, K2 x41, K3 x81)
# plus the pose encoder (K2 x8) and the VAE encoder (K3 x22); the backward
# skips the first level-0 spatial attention, which runs before the first
# trainable pose merge.
TRAIN_STEPS = 5
TRAIN_PER_STEP = {"flash": 10, "flash_bwd": 9, "temporal": 49, "temporal_bwd": 49,
                  "group_norm": 103}
COMPOSE_LR = 1e-4
# Stand-ins for the TPU kernels off the main path, on the same CUDA kernels:
# K4/K7 (padded, S % 8 != 0) at latents 33x49 (264x392 px), K6 (q-blocked)
# at the 512x768 level-0 length.
K47_KEY = ("k4/k7", 2, 1617, 320, 8, 40 ** -0.5)
K6_KEY = ("k6", 2, 6144, 320, 8, 40 ** -0.5)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> list[str]:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader``, a line a card."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()


def rates_for(name: str, sms: int) -> tuple[str, dict]:
    """The data-sheet rates of the card's form, with the exponential rate of
    its ``sms`` SMs at its top SM clock under ``exp``."""
    form = next((f for f in ("PCIe", "NVL") if f in name), "SXM")
    mhz = float(smi("clocks.max.sm")[0].split()[0])
    return form, dict(RATES[form], exp=sms * EX2_PER_CLOCK * mhz * 1e6)


def kernel_name(mangled: str) -> str:
    """'flash_fwd_wgmma<48, 40>' from an Itanium-mangled kernel symbol: its
    last name with its integer template arguments."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    return name + (f"<{', '.join(re.findall(r'Li(-?\d+)E', args.group(1)))}>" if args else "")


def ptxas_resources(text: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ``ptxas -v`` output."""
    res, cur = {}, None
    for ln in text.splitlines():
        if m := re.search(r"Function properties for (\S+)", ln):
            cur = kernel_name(m.group(1))
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            res[cur] = (0, int(m.group(1)), int(m.group(2)))
        elif cur in res and (m := re.search(r"Used (\d+) registers", ln)):
            res[cur] = (int(m.group(1)),) + res[cur][1:]
    return res


def bound(flops, nbytes, exps, rate, rates) -> tuple[float, str]:
    """The least time (ms) the card could take and what sets it: the largest
    of operations at the peak rate of their type, bytes at the memory rate,
    and exponentials at the special-function units' rate."""
    terms = {"operations": flops / rates[rate], "bytes": nbytes / rates["bytes"],
             "exponentials": exps / rates["exp"]}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def time_ms(fn, arg_sets, reps: int = 10, warmup: int = 3, queued: bool = False) -> float:
    """Median CUDA-event time of one call, rotating over fresh input sets.
    By default the device is idle when each call starts, so the event pair
    brackets the host's launch cost as well, which is the larger part at
    small shapes.  With `queued` the timed calls wait behind a device-side
    sleep that outlasts the host's time to issue them, so each pair brackets
    the call's device work only."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    if queued:
        t0 = time.perf_counter()
        fn(*arg_sets[0])
        torch.cuda.synchronize()
        issue_s = time.perf_counter() - t0  # host and device: bounds the host's issue time
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * (2 * reps * issue_s + 1e-3)))
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


def bwd_ok(err: float, rel: float) -> bool:
    return err < BWD_TOL and rel < BWD_REL_TOL


def camera(kind: str, b: int = 1, frames=None, height=None, width=None):
    """Intrinsics as scripts/generate.py builds them ([w, h, 0, 0]); c2w either
    identity or a synthetic pan (translation along x plus a slow yaw).  The
    size defaults to FRAMES x HEIGHT x WIDTH."""
    frames, height, width = frames or FRAMES, height or HEIGHT, width or WIDTH
    intr = torch.tensor([width, height, 0.0, 0.0]).expand(b, frames, 4).contiguous()
    c2w = torch.eye(4).expand(b, frames, 4, 4).contiguous()
    if kind == "pan":
        s = torch.linspace(0.0, 1.0, frames)
        ang = 0.3 * s
        c2w[..., 0, 0] = c2w[..., 2, 2] = torch.cos(ang)
        c2w[..., 0, 2], c2w[..., 2, 0] = torch.sin(ang), -torch.sin(ang)
        c2w[..., 0, 3] = s
    return intr, c2w


def plucker(pipe, kind: str, frames=None, height=None, width=None):
    """The Plücker video of ``camera(kind)`` on the pipeline's device."""
    from synfmc_tpu_torch.geometry.plucker import plucker_embedding

    height, width = height or HEIGHT, width or WIDTH
    intr, c2w = camera(kind, frames=frames, height=height, width=width)
    return plucker_embedding(intr.to(pipe.device), c2w.to(pipe.device), height, width)


def objects(seed: int, frames: int, height: int, width: int):
    """N_OBJECTS seeded object trajectories as the obj stage's dataset gives
    them: (1, F, O, 12) camera-relative [R|t] rows (a yaw that turns, a
    translation that drifts) and (1, F, O, H, W) Gaussian sphere masks
    (obj.yaml use_sphere_mask: a filled circle times a Gaussian of sigma
    radius / 2, 1 at the centre) whose centres slide across the frame."""
    rng = np.random.default_rng(seed)
    info = np.zeros((1, frames, N_OBJECTS, 3, 4), np.float32)
    masks = np.zeros((1, frames, N_OBJECTS, height, width), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    s = np.linspace(0.0, 1.0, frames)
    for o in range(N_OBJECTS):
        yaw = rng.uniform(-np.pi, np.pi) + rng.uniform(-0.5, 0.5) * s
        info[0, :, o, 0, 0] = info[0, :, o, 2, 2] = np.cos(yaw)
        info[0, :, o, 0, 2], info[0, :, o, 2, 0] = np.sin(yaw), -np.sin(yaw)
        info[0, :, o, 1, 1] = 1.0
        info[0, :, o, :, 3] = rng.uniform(-1, 1, 3) + np.outer(s, rng.uniform(-0.5, 0.5, 3))
        c0, c1 = (rng.uniform([0.2 * width, 0.25 * height], [0.8 * width, 0.75 * height])
                  for _ in range(2))
        radius = int(rng.uniform(0.1, 0.2) * height)
        for f in range(frames):
            cx, cy = c0 + (c1 - c0) * s[f]
            d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            masks[0, f, o] = (d <= radius) * np.exp(-0.5 * (d / (radius / 2)) ** 2)
    return info.reshape(1, frames, N_OBJECTS, 12), masks


def object_traj(pipe, seed: int, frames=None, height=None, width=None):
    """Traj features made the serving way: seeded objects ->
    rasterize_traj_features -> build_adapter_inputs -> the ObjectAdapter
    (FRAMES x HEIGHT x WIDTH by default)."""
    from synfmc_tpu_torch.utils.traj_features import build_adapter_inputs

    frames, height, width = frames or FRAMES, height or HEIGHT, width or WIDTH
    info, masks = objects(seed, frames, height, width)
    feats, mask = build_adapter_inputs(torch.from_numpy(info).to(pipe.device),
                                       torch.from_numpy(masks).to(pipe.device))
    return pipe.encode_traj(feats, mask, frames)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


class _Shim:
    """A recording stand-in for a kernel wrapper: records each call's
    arguments, then calls the wrapper.  ``launches`` reads and writes the
    wrapper's own counter, which the wrapper bumps through its module name."""

    def __init__(self, fn, record):
        self.fn, self.record = fn, record

    def __call__(self, *a, **kw):
        self.record(*a, **kw)
        return self.fn(*a, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


class Recorder:
    """Wraps every kernel wrapper at its call site (the attention router,
    ops.norms, and the backward calls of the autograd Functions) to count
    the shapes and arguments the running code gives each kernel, keyed by
    ``self.stage``.  The wrappers themselves run unchanged."""

    def __init__(self, stage: str):
        self.stage = stage
        self.seen = {k: Counter() for k in ("flash", "temporal", "group_norm", "flash_bwd",
                                            "temporal_bwd", "group_norm_bwd")}

    def __enter__(self):
        import synfmc_tpu_torch.ops.attention as attn_mod
        import synfmc_tpu_torch.ops.flash_attention as fa_mod
        import synfmc_tpu_torch.ops.fused_groupnorm as gn_mod
        import synfmc_tpu_torch.ops.norms as norms_mod
        import synfmc_tpu_torch.ops.temporal_attention as ta_mod

        seen = self.seen

        def attn(kind, fn):
            def record(q, *a):  # (q, k, v, [out, lse,] [dout,] scale, heads)
                seen[kind][(self.stage,) + tuple(q.shape) + (a[-1], a[-2])] += 1
            return _Shim(fn, record)

        def gn(kind, fn):
            def record(x, *a, **kw):
                n, c = x.shape[0], x.shape[-1]
                groups, eps, act = (list(a[2:]) + [kw.get("eps", 1e-5), kw.get("act")])[:3] \
                    if kind == "group_norm" else (a[3], a[4], a[5])
                seen[kind][(self.stage, n, x.numel() // (n * c), c, groups, eps, act)] += 1
            return _Shim(fn, record)

        self.sites = [(attn_mod, "flash_attention", "flash", attn),
                      (attn_mod, "temporal_attention", "temporal", attn),
                      (norms_mod, "fused_group_norm", "group_norm", gn),
                      (fa_mod, "flash_attention_bwd", "flash_bwd", attn),
                      (ta_mod, "temporal_attention_bwd", "temporal_bwd", attn),
                      (gn_mod, "group_norm_bwd", "group_norm_bwd", gn)]
        self.real = [getattr(mod, name) for mod, name, _, _ in self.sites]
        for (mod, name, kind, shim), fn in zip(self.sites, self.real):
            setattr(mod, name, shim(kind, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name, _, _), fn in zip(self.sites, self.real):
            setattr(mod, name, fn)


def record_shapes(pipe):
    """Recorded, to collect the shapes and arguments the serving modes give
    each kernel, by stage: the pose encoder, the ObjectAdapter, one
    full-width UNet forward on the CFG pair (with DeepCache's tensor), one at
    batch B on the cond half (a CFG-cache step), one shallow forward on the
    pair (a DeepCache step), one VAE frame decode and one decode of
    DECODE_CHUNK frames, and the serve daemon's group of two requests (the
    pose encoder at batch 2, the UNet on both pairs at batch 4, no traj
    features).  Checks each stage's launches against PER_STAGE."""
    with Recorder("pose") as rec:
        dev = pipe.device
        with torch.inference_mode():
            pose = pipe.encode_pose(plucker(pipe, "pan"))
            rec.stage = "adapter"
            traj = object_traj(pipe, seed=0)
            rec.stage = "unet"
            lat = torch.randn(2, FRAMES, HEIGHT // 8, WIDTH // 8, 4, device=dev)
            ctx = pipe.encode_prompt("a turtle paddles through a coral reef")
            t = torch.full((2,), 751, device=dev)
            pose2 = [torch.cat([p, p]) for p in pose]
            traj2 = [torch.cat([torch.zeros_like(tr), tr]) for tr in traj]
            _, deep = pipe.unet(lat, t, ctx, pose_features=pose2, traj_features=traj2,
                                return_deep=True)
            rec.stage = "unet_b"
            pipe.unet(lat[1:], t[1:], ctx[1:], pose_features=pose, traj_features=traj)
            rec.stage = "shallow"
            pipe.unet(lat, t, ctx, pose_features=pose2, traj_features=traj2, deep_cache=deep)
            rec.stage = "vae"
            pipe.vae.decode(lat[:1, 0])
            rec.stage = "vae_chunk"
            pipe.vae.decode(lat[0, :DECODE_CHUNK])
            rec.stage = "pose_2"
            pose_two = pipe.encode_pose(torch.cat([plucker(pipe, "pan")] * 2))
            rec.stage = "unet_2"
            pipe.unet(torch.cat([lat, lat]), torch.cat([t, t]), torch.cat([ctx[:1], ctx[:1],
                                                                           ctx[1:], ctx[1:]]),
                      pose_features=[torch.cat([p, p]) for p in pose_two])
        torch.cuda.synchronize()
    seen = {k: rec.seen[k] for k in ("flash", "temporal", "group_norm")}
    for stage, want in PER_STAGE.items():
        got = {k: sum(n for key, n in v.items() if key[0] == stage) for k, v in seen.items()}
        if got != {k: want.get(k, 0) for k in seen}:
            raise AssertionError(f"{stage}: launches {got} != {want}")
    # the shallow forward's shapes are all the pair forward's: time them once
    for kind, keys in seen.items():
        shallow = [key for key in keys if key[0] == "shallow"]
        if any(("unet",) + key[1:] not in keys for key in shallow):
            raise AssertionError(f"{kind}: a shallow-forward shape the full forward lacks")
        for key in shallow:
            del keys[key]
    return seen


def kernel_case(kind, key, dtype, gen):
    """(kernel fn, plain fn, library fn, input sets, flops, bytes, flop rate
    key, exponentials)."""
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
                sets, 4.0 * b * heads * s * s * d, 4.0 * b * s * c * esize, "bf16",
                float(b * heads * s * s))  # one exponential a logit
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
            library, sets, float(ops), 2.0 * n * s * c * esize, "f32",
            float(n * s * c if act == "silu" else 0))  # SiLU's sigmoid


def _row(kind, key, count, err, rel, kern, plain, lib, sets, flops, nbytes, rate, exps, rates):
    bound_ms, bound_by = bound(flops, nbytes, exps, rate, rates)
    row = dict(key=key, per_forward=count, err=err, rel=rel, ms=time_ms(kern, sets),
               plain_ms=time_ms(plain, sets, reps=5, warmup=1),
               library_ms=time_ms(lib, sets), bound_ms=bound_ms, bound_by=bound_by,
               device_ms=time_ms(kern, sets, queued=True),
               library_device_ms=time_ms(lib, sets, queued=True))
    log(f"  {kind:12s} {str(key[:-2] if 'group_norm' not in kind else key):60s} "
        f"x{count:3d} err={err:.2e} rel={rel:.2e} ms={row['ms']:.4f} "
        f"plain={row['plain_ms']:.4f} lib={row['library_ms']:.4f} "
        f"bound={row['bound_ms']:.4f} ({row['bound_by']}) "
        f"device={row['device_ms']:.4f} lib_device={row['library_device_ms']:.4f}")
    return row


def device_events(fn, tries: int = 3) -> list[tuple[str, float]]:
    """(name, device ms) of each CUDA kernel that one call of ``fn`` launches,
    from a torch.profiler window; torch.cuda._sleep's own kernel is left out.
    The call waits behind a 5 ms device sleep, and the window stays open
    20 ms after the device is done: the tracer can drop the kernels near the
    edges of its window.  A window that holds no device event at all, the
    sleep's included, is a lost trace: it is logged and taken again, up to
    ``tries`` windows in all."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * 5e-3))
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in events
                    if "spin_kernel" not in e.name]
        log(f"[trace] window {attempt} of {tries} holds no device event")
    raise AssertionError(f"the tracer recorded no device event in {tries} windows")


def gn_launches(fn) -> Counter:
    """CUDA kernels one call of ``fn`` launches, from a trace: K3's by their
    kernel name, others by the start of theirs."""
    fn()
    torch.cuda.synchronize()
    return Counter(next((k for k in ("gn_cluster", "gn_partials", "gn_apply") if k in name),
                        name[:40])
                   for name, _ in device_events(fn))


def gn_plan_row(key, kern, sets, row, traced):
    """K3's plan at ``key`` in the kernel line: mode, cluster size, blocks;
    at the first key of each mode (``traced`` holds those seen) the kernels
    one call launches, from a trace, checked (mode A: one gn_cluster; mode
    B: gn_partials then gn_apply)."""
    from synfmc_tpu_torch.ops.fused_groupnorm import _plan

    _, n, s, c, groups, eps, act = key
    plan = _plan(n, s, c, groups, sets[0][0].element_size())
    row["plan"] = plan._asdict()
    text = f"plan {plan.mode} run={plan.run} cluster={plan.cluster} blocks={plan.blocks}"
    if plan.mode not in traced:
        traced.add(plan.mode)
        names = gn_launches(lambda: kern(*sets[0]))
        want = ["gn_cluster"] if plan.mode == "A" else ["gn_partials", "gn_apply"]
        if names != Counter(want):
            raise AssertionError(f"group_norm {key}: plan {plan.mode} launched {dict(names)}")
        text += f"; kernels per call {dict(names)}"
    log(f"  {'':12s} {text}")


# K3's SiLU against v * sigmoid(v) in float64: bf16 within one unit in the
# last place of the output (its rounding is half of that), fp32 within 2**-16.
SILU_REL_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 2 ** -16}


def gn_silu_range() -> None:
    """K3's fused SiLU over v in [-20, 20]: with scale 0 and bias v a
    channel's output is silu(v) whatever the statistics, so every channel of
    a (2, 64, 4096) slab checks one v.  Largest absolute and relative errors
    against v * sigmoid(v) in float64 on the same (rounded) v."""
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm

    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype, tol in SILU_REL_TOL.items():
        v = torch.linspace(-20, 20, 4096, device="cuda").to(dtype)
        x = torch.randn(2, 64, 4096, generator=gen, device="cuda").to(dtype)
        got = fused_group_norm(x, torch.zeros_like(v), v, 32, 1e-6, "silu").double()
        want = v.double() * torch.sigmoid(v.double())
        err = (got - want).abs()
        rel = torch.where(want != 0, err / want.abs(), err)
        worst = int(rel.flatten().argmax()) % 4096
        log(f"[kernels] K3 silu over v in [-20, 20], {dtype}: max abs {err.max().item():.3e}, "
            f"max rel {rel.max().item():.3e} (limit {tol:.3e}) at v = {v[worst].item():.4f}")
        if rel.max().item() > tol:
            raise AssertionError(f"K3 silu {dtype}: relative error {rel.max().item()} > {tol}")


def check_kernels(seen, rates, traced, fp32=True):
    """Forward kernels at the recorded keys (bf16), then one fp32 case each;
    ``traced``: the K3 modes whose launches a trace has checked."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {k: [] for k in seen}
    for kind, keys in seen.items():
        for key, count in sorted(keys.items(), key=lambda kv: str(kv[0])):
            kern, plain, lib, sets, flops, nbytes, rate, exps = kernel_case(kind, key,
                                                                           torch.bfloat16, gen)
            want = plain(*(x.float() for x in sets[0]))
            err, rel = kernel_error(kern(*sets[0]), want)
            torch.cuda.synchronize()
            if not bf16_ok(err, rel):
                raise AssertionError(f"{kind} {key}: bf16 max abs err {err} (limit {BF16_TOL}), "
                                     f"{rel} of the largest output (limit {BF16_REL_TOL})")
            results[kind].append(_row(kind, key, count, err, rel, kern, plain, lib, sets, flops,
                                      nbytes, rate, exps, rates))
            if kind == "group_norm":
                gn_plan_row(key, kern, sets, results[kind][-1], traced)
    if not fp32:
        return results
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
        log(f"  {kind:12s} fp32 {key[1:4]} err={err:.2e}")
    return results


# ---------------------------------------------------------------------------
# phase 8: the train step's kernels against their plain versions
# ---------------------------------------------------------------------------


def bwd_case(kind, key, dtype, gen):
    """A backward kernel at ``key`` = (stage, rows, seq, channels, heads, scale):
    (kernel fn, plain fn, library fn, input sets, library sets, flops, bytes,
    exponentials).
    The flash backward takes K1's output and log-sum-exp of the same inputs;
    the library is SDPA's backward through a graph built once per set."""
    from synfmc_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
    )
    from synfmc_tpu_torch.ops.temporal_attention import (
        temporal_attention_bwd,
        temporal_attention_bwd_plain,
    )

    _, b, s, c, heads, scale = key
    d = c // heads
    esize = torch.finfo(dtype).bits // 8
    rnd = lambda: torch.randn(b, s, c, generator=gen, device="cuda").to(dtype)
    view = lambda x: x.detach().view(b, s, heads, d).transpose(1, 2)
    sets, lib_sets = [], []
    for _ in range(2):
        q, k, v, do = rnd(), rnd(), rnd(), rnd()
        if kind == "flash_bwd":
            o, lse = flash_attention_fwd(q, k, v, scale, heads, with_lse=True)
            sets.append((q, k, v, o, lse, do))
        else:
            sets.append((q, k, v, do))
        ins = [view(x).requires_grad_() for x in (q, k, v)]
        lib_sets.append((F.scaled_dot_product_attention(*ins, scale=scale), ins, view(do)))
    if kind == "flash_bwd":
        kern = lambda q, k, v, o, lse, do: flash_attention_bwd(q, k, v, o, lse, do, scale, heads)
        plain = lambda q, k, v, o, lse, do: flash_attention_bwd_plain(q, k, v, do, scale, heads)
    else:
        kern = lambda q, k, v, do: temporal_attention_bwd(q, k, v, do, scale, heads)
        plain = lambda q, k, v, do: temporal_attention_bwd_plain(q, k, v, do, scale, heads)
    lib = lambda out, ins, g: torch.autograd.grad(out, ins, g, retain_graph=True)
    # 5 products of 2*S*S*D per (row, head); q, k, v, dO read, dq, dk, dv
    # written; P recomputed once, one exponential a logit
    return (kern, plain, lib, sets, lib_sets, 10.0 * b * heads * s * s * d,
            7.0 * b * s * c * esize, float(b * heads * s * s))


def _bwd_errors(kind, key, got, want, ok, limit):
    errs = [kernel_error(g, w) for g, w in zip(got, want)]
    for name, (err, rel) in zip(("dq", "dk", "dv"), errs):
        if not ok(err, rel):
            raise AssertionError(f"{kind} {key} {name}: max abs err {err}, {rel} of the "
                                 f"largest gradient (limits {limit})")
    return max(e for e, _ in errs), max(r for _, r in errs)


def check_bwd(seen, rates):
    """Backward kernels at the recorded keys and the stand-ins (bf16,
    gradient by gradient), then one fp32 case each."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {"flash_bwd": [], "temporal_bwd": []}
    for kind in results:
        for key, count in sorted(seen[kind].items(), key=lambda kv: str(kv[0])):
            kern, plain, lib, sets, lib_sets, flops, nbytes, exps = bwd_case(
                kind, key, torch.bfloat16, gen)
            want = plain(*(x.float() for x in sets[0]))
            err, rel = _bwd_errors(kind, key, kern(*sets[0]), want, bwd_ok,
                                   (BWD_TOL, BWD_REL_TOL))
            torch.cuda.synchronize()
            bound_ms, bound_by = bound(flops, nbytes, exps, "bf16", rates)
            row = dict(key=key, per_forward=count, err=err, rel=rel, ms=time_ms(kern, sets),
                       plain_ms=time_ms(plain, sets, reps=3, warmup=1),
                       library_ms=time_ms(lib, lib_sets), bound_ms=bound_ms, bound_by=bound_by,
                       device_ms=time_ms(kern, sets, queued=True),
                       library_device_ms=time_ms(lib, lib_sets, queued=True))
            results[kind].append(row)
            log(f"  {kind:12s} {str(key[:-1]):44s} x{count:3d} err={err:.2e} rel={rel:.2e} "
                f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} lib={row['library_ms']:.4f} "
                f"bound={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"device={row['device_ms']:.4f} lib_device={row['library_device_ms']:.4f}")
            del sets, lib_sets
            torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kind, key in (("flash_bwd", ("f32", 2, 389, 640, 8, 80 ** -0.5)),
                      ("temporal_bwd", ("f32", 768, 16, 640, 8, 80 ** -0.5))):
        kern, plain, _, sets, *_ = bwd_case(kind, key, torch.float32, gen)
        ok = lambda err, rel: rel < F32_TOL
        _, rel = _bwd_errors(kind, key, kern(*sets[0]), plain(*sets[0]), ok, F32_TOL)
        log(f"  {kind:12s} fp32 {key[1:4]} max err {rel:.2e} of the largest gradient")
    return results


def trace_kernels(fn, match, reps=10) -> Counter:
    """Device ms per call of each CUDA kernel whose name contains ``match``
    (every kernel when it is empty), from a torch.profiler trace of ``reps``
    calls of ``fn`` queued back to back after 3 untraced ones."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    kernels = Counter()
    for name, ms in device_events(calls):
        if match in name:
            kernels[name[:90]] += ms / reps
    return kernels


def flash_fwd_kernels(b, s, c, heads):
    """K1 at (b, s, c, heads) in bf16 with its log-sum-exp, as the train step
    calls it: device ms per call by kernel name (flash_fwd_*), and the kernels
    SDPA's forward launches on the same inputs."""
    from synfmc_tpu_torch.ops.flash_attention import flash_attention_fwd

    d = c // heads
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(b, s, c, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    view = lambda x: x.view(b, s, heads, d).transpose(1, 2)
    ours = trace_kernels(lambda: flash_attention_fwd(q, k, v, d ** -0.5, heads, with_lse=True),
                         "flash_fwd")
    if not ours:
        raise AssertionError("flash_fwd_kernels: the trace holds no flash_fwd kernel")
    lib = trace_kernels(lambda: F.scaled_dot_product_attention(view(q), view(k), view(v),
                                                               scale=d ** -0.5), "")
    return {"shape": [b, s, c, heads], "k1_kernels_device_ms": dict(ours),
            "k1_device_ms": sum(ours.values()),
            "library_kernels_device_ms": dict(lib.most_common(6))}


def flash_bwd_passes(b, s, c, heads):
    """Device ms of each pass of the flash backward (kernel names flash_bwd_*)
    per call at (b, s, c, heads) in bf16, from a torch.profiler trace."""

    from synfmc_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(b, s, c, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = (c // heads) ** -0.5
    o, lse = flash_attention_fwd(q, k, v, scale, heads, with_lse=True)
    passes = Counter()
    for name, ms in trace_kernels(lambda: flash_attention_bwd(q, k, v, o, lse, do, scale, heads),
                                  "flash_bwd").items():
        found = re.search(r"flash_bwd_(?:prologue|delta|dkdv|dq)", name)
        if found:
            passes[found.group(0)] += ms
    if not passes:
        raise AssertionError("flash_bwd_passes: the trace holds no flash_bwd kernel")
    return {"shape": [b, s, c, heads], "passes_device_ms": dict(passes),
            "total_device_ms": sum(passes.values())}


def library_bwd_kernels(b, s, c, heads):
    """SDPA's backward at (b, s, c, heads) in bf16: device ms per call of each
    kernel it launches, from a torch.profiler trace."""
    d = c // heads
    gen = torch.Generator(device="cuda").manual_seed(5)
    ins = [torch.randn(b, heads, s, d, generator=gen, device="cuda").to(torch.bfloat16)
           .requires_grad_() for _ in range(3)]
    out = F.scaled_dot_product_attention(*ins, scale=d ** -0.5)
    g = torch.randn_like(out)
    kernels = trace_kernels(lambda: torch.autograd.grad(out, ins, g, retain_graph=True), "")
    return {"shape": [b, s, c, heads], "library_kernels_device_ms": dict(kernels.most_common(6))}


def time_gn_bwd(seen, rates):
    """The GroupNorm backward (PyTorch ops on both devices, as the JAX package
    differentiates XLA's GroupNorm) at the recorded train keys, against
    F.group_norm's own backward."""
    from synfmc_tpu_torch.ops.fused_groupnorm import group_norm_bwd

    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for key, count in sorted(seen.items(), key=lambda kv: str(kv[0])):
        _, n, s, c, groups, eps, act = key
        sets, lib_sets = [], []
        for _ in range(2):
            x = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
            w = torch.ones(c, device="cuda", dtype=torch.bfloat16)
            g = torch.randn(n, s, c, generator=gen, device="cuda").to(torch.bfloat16)
            sets.append((x, w, g))
            xl = x.transpose(1, 2).unsqueeze(-1).detach().requires_grad_()
            y = F.group_norm(xl, groups, w, torch.zeros_like(w), eps)
            y = F.silu(y) if act == "silu" else (F.relu(y) if act == "relu" else y)
            lib_sets.append((y, xl, g.transpose(1, 2).unsqueeze(-1)))
        fn = lambda x, w, g: group_norm_bwd(x, w, torch.zeros_like(w), g, groups, eps, act,
                                            affine=False)
        lib = lambda y, xl, g: torch.autograd.grad(y, xl, g, retain_graph=True)
        bound = 3.0 * n * s * c * 2 / rates["bytes"] * 1e3  # x, dout read; dx written
        row = dict(key=key, count=count, ms=time_ms(fn, sets, reps=5),
                   library_ms=time_ms(lib, lib_sets, reps=5), bound_ms=bound)
        rows.append(row)
        log(f"  group_norm_bwd {str(key[1:]):44s} x{count:3d} ms={row['ms']:.4f} "
            f"lib={row['library_ms']:.4f} bound={bound:.4f} (bytes)")
    return rows


# ---------------------------------------------------------------------------
# phase 4: composition at tiny width, GPU kernels against CPU plain versions
# ---------------------------------------------------------------------------


def tiny_config(mixed_precision: bool, path: str = CAM_YAML):
    from synfmc_tpu_torch.pipelines.factory import load_config

    cfg = load_config(path)
    cfg["model_overrides"] = TINY_OVERRIDES
    cfg["unet_additional_kwargs"]["motion_module_kwargs"]["num_attention_heads"] = 4
    cfg["pose_encoder_kwargs"]["temporal_attention_nhead"] = 4
    cfg["mixed_precision_training"] = mixed_precision
    return cfg


# Phase 4's OMC request runs at the serving resolution on 8 frames (at 16 its
# CPU side took ~30 s of the script's 1200, which the mesh phase needs).
COMPOSE_FRAMES = 8
# Composition cases: (label, frames, height, width, objects?, pipeline
# arguments).  The first is one OMC request at the serving resolution; the modes
# run at 8 frames of 128x192, where K1 still takes level 0 (384 tokens); the
# multidiff windows of 8 frames overlap by 4 (12 frames, within the pose
# encoder's 16 positions) and decode 4 frames a call.
COMPOSE_CASES = [
    ("omc", COMPOSE_FRAMES, HEIGHT, WIDTH, True, {}),
    ("dpmpp", 8, 128, 192, True, dict(solver="dpmpp_2m")),
    ("deepcache", 8, 128, 192, True, dict(deepcache_interval=2)),
    ("cfgcache", 8, 128, 192, True, dict(cfg_cache_interval=2)),
    ("turbo+dpmpp", 8, 128, 192, True,
     dict(deepcache_interval=2, cfg_cache_interval=2, solver="dpmpp_2m")),
    ("multidiff+chunked decode", 8, 128, 192, False,
     dict(multidiff_total_steps=2, multidiff_overlaps=4, decode_chunk=DECODE_CHUNK)),
]


def compose():
    """The tiny obj-stage pipeline in fp32 on the GPU (kernels) and on the CPU
    (plain versions) with the same weights and inputs, 3 steps (the OMC gate
    closes at the last), in every case of COMPOSE_CASES: final latents within
    LATENT_TOL, and the decoded frames too where the case decodes in chunks."""
    from synfmc_tpu_torch.pipelines.animation import decode_latents
    from synfmc_tpu_torch.pipelines.factory import build_pipeline, randomize_pipeline_

    cfg = tiny_config(mixed_precision=False, path=OBJ_YAML)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every conditioning path live: the seeded weights without the structural zeros
    cpu = randomize_pipeline_(build_pipeline(cfg, stage="obj", device="cpu", dtype=torch.float32,
                                             seed=0, allow_untrained_cm=True)[0], 0)
    gpu = build_pipeline(cfg, stage="obj", device="cuda", dtype=torch.float32, seed=1,
                         allow_untrained_cm=True)[0]
    for name in ("unet", "vae", "text_encoder", "pose_encoder", "adapter"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    rng = np.random.default_rng(7)
    errors = {}
    for label, frames, height, width, objs, kw in COMPOSE_CASES:
        overlap = kw.get("multidiff_overlaps", 0)
        total = kw.get("multidiff_total_steps", 1) * (frames - overlap) + overlap
        latents = torch.from_numpy(rng.normal(size=(1, total, height // 8, width // 8, 4))
                                   .astype(np.float32))
        out = {}
        for name, pipe in (("gpu", gpu), ("cpu", cpu)):
            t0 = time.perf_counter()
            traj = object_traj(pipe, 11, frames, height, width) if objs else None
            lat = pipe(["a knight marches across a field"], video_length=frames, height=height,
                       width=width, latents=latents.to(pipe.device),
                       plucker=plucker(pipe, "pan", total, height, width), traj_features=traj,
                       num_inference_steps=3, guidance_scale=GUIDANCE, omcm_min_step=300,
                       decode=False, **{k: v for k, v in kw.items() if k != "decode_chunk"})
            img = decode_latents(pipe.vae, lat, decode_chunk=kw.get("decode_chunk", 1))
            out[name] = (lat.cpu(), img.cpu())
            log(f"  {label} {name}: {time.perf_counter() - t0:.1f} s")
        lat_err = (out["gpu"][0] - out["cpu"][0]).abs().max().item()
        img_err = (out["gpu"][1] - out["cpu"][1]).abs().max().item()
        chunked = "decode_chunk" in kw
        log(f"  {label}: {total} frames {height}x{width}, latents max abs err {lat_err:.3e} "
            f"(limit {LATENT_TOL}), frames {img_err:.3e}"
            + (f" (limit {LATENT_TOL}, {kw['decode_chunk']} a call)" if chunked else ""))
        if not lat_err < LATENT_TOL or (chunked and not img_err < LATENT_TOL):
            raise AssertionError(f"composition {label}: latents differ by {lat_err}, "
                                 f"frames by {img_err}")
        errors[label] = (lat_err, img_err)
    del cpu, gpu
    torch.cuda.empty_cache()
    return errors


# ---------------------------------------------------------------------------
# phase 5: the train step at tiny width, GPU kernels against CPU plain versions
# ---------------------------------------------------------------------------


def synthetic_batches(seed: int, b: int = 1):
    """Collated raw batches in the dataset's format: pixels in [-1, 1], two
    captions, a pan camera (slow yaw plus a slide along x) as relative
    [R|t] rows, intrinsics [w, h, 0, 0], a rectangle object mask."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 1.0, FRAMES, dtype=np.float32)
    rt = np.zeros((b, FRAMES, 3, 4), np.float32)
    rt[..., 0, 0] = rt[..., 2, 2] = np.cos(0.3 * s)
    rt[..., 0, 2], rt[..., 2, 0] = np.sin(0.3 * s), -np.sin(0.3 * s)
    rt[..., 1, 1] = 1.0
    rt[..., 0, 3] = s
    mask = np.zeros((b, FRAMES, HEIGHT, WIDTH, 1), np.float32)
    mask[:, :, HEIGHT // 4:3 * HEIGHT // 4, WIDTH // 3:2 * WIDTH // 3] = 1.0
    while True:
        yield {
            "pixel_values": rng.uniform(-1, 1, (b, FRAMES, HEIGHT, WIDTH, 3)).astype(np.float32),
            "captions": ["a knight marches across a field"] * b,
            "background_captions": ["a grassy field under a grey sky"] * b,
            "camera_rt": rt.reshape(b, FRAMES, 12),
            "intrinsics": np.tile(np.array([WIDTH, HEIGHT, 0, 0], np.float32), (b, FRAMES, 1)),
            "obj_union_mask": mask,
            "flip_flag": np.zeros(b, bool),
        }


def train_compose():
    """Two stage-2 steps of the tiny model in fp32 on each device, with the
    same weights, batches and draws."""
    from synfmc_tpu_torch.data.tokenizer import HashTokenizer
    from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
    from synfmc_tpu_torch.pipelines.factory import build_models, init_random_
    from synfmc_tpu_torch.training.optim import make_optimizer
    from synfmc_tpu_torch.training.params import partition_params, stage2_cmc_unet_trainable
    from synfmc_tpu_torch.training.steps import (
        apply_grads,
        draw_cam,
        init_train_state,
        make_cam_grads_fn,
    )
    from synfmc_tpu_torch.training.trainers import host_batch, step_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_config(mixed_precision=False)
    scfg = step_config(cfg, "cam")
    schedule = DiffusionSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    cpu = build_models(cfg)
    gen = torch.Generator().manual_seed(0)
    for m in cpu.values():
        init_random_(m, gen)
    with torch.device("cuda"):
        gpu = build_models(cfg)
    for name, m in gpu.items():
        m.load_state_dict(cpu[name].state_dict())
    sides = {}
    for dev, models in (("cuda", gpu), ("cpu", cpu)):
        trainable = {**partition_params(models["unet"], stage2_cmc_unet_trainable, "unet."),
                     **partition_params(models["pose_encoder"], lambda n: True, "pose_encoder.")}
        for name in ("vae", "text"):
            partition_params(models[name], lambda n: False)
        sides[dev] = (init_train_state(trainable, make_optimizer(COMPOSE_LR)),
                      make_cam_grads_fn(models["unet"], models["pose_encoder"], models["vae"],
                                        models["text"], schedule, scfg))
    tok, batches = HashTokenizer(), synthetic_batches(3)
    for step in range(2):
        raw = next(batches)
        draws = draw_cam(torch.Generator().manual_seed(100 + step),
                         host_batch(raw, tok, "cpu"), scfg, schedule)
        out = {}
        for dev, (state, grads_fn) in sides.items():
            t0 = time.perf_counter()
            out[dev] = grads_fn(state.trainable, host_batch(raw, tok, dev), draws.to(dev))
            log(f"  step {step + 1} {dev}: {time.perf_counter() - t0:.1f} s, "
                f"loss {float(out[dev][1]['loss']):.6f}")
        if step == 0:
            lg, lc = float(out["cuda"][1]["loss"]), float(out["cpu"][1]["loss"])
            loss_rel = abs(lg - lc) / abs(lc)
            grad_rel = max(kernel_error(out["cuda"][0][n].cpu(), g)[1]
                           for n, g in out["cpu"][0].items())
            log(f"  loss rel err {loss_rel:.2e} (limit 1e-5); largest gradient error "
                f"{grad_rel:.2e} of its tensor's largest magnitude (limit 1e-3)")
            if not (loss_rel < 1e-5 and grad_rel < 1e-3):
                raise AssertionError(f"train-compose: loss {lg} vs {lc}, gradients {grad_rel}")
        for dev, (state, _) in sides.items():
            apply_grads(state, out[dev][0])
    gpu_p, cpu_p = sides["cuda"][0].trainable, sides["cpu"][0].trainable
    param_err = max((gpu_p[n].detach().cpu() - p.detach()).abs().max().item()
                    for n, p in cpu_p.items())
    log(f"  parameters after 2 AdamW steps: max abs diff {param_err:.2e} "
        f"(limit 2 lr = {2 * COMPOSE_LR:.0e})")
    if not param_err < 2 * COMPOSE_LR:
        raise AssertionError(f"train-compose: parameters differ by {param_err}")
    del sides, cpu, gpu
    torch.cuda.empty_cache()
    return loss_rel, grad_rel, param_err


# ---------------------------------------------------------------------------
# phase 6: the serving path at full width
# ---------------------------------------------------------------------------


def counters():
    from synfmc_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from synfmc_tpu_torch.ops.fused_groupnorm import fused_group_norm
    from synfmc_tpu_torch.ops.temporal_attention import temporal_attention, temporal_attention_bwd

    return {"flash": flash_attention, "flash_bwd": flash_attention_bwd,
            "temporal": temporal_attention, "temporal_bwd": temporal_attention_bwd,
            "group_norm": fused_group_norm}


def forward_plan(kw: dict) -> list[tuple[str, int]]:
    """The UNet forwards a request of STEPS steps runs, in order, as (kind,
    batch): every k-th step of a cache mode refreshes on the CFG pair; the
    others run the shallow level (DeepCache) and/or the cond branch alone at
    batch 1 (CFG-cache); multidiff runs the pair once a window."""
    deep, cfg = kw.get("deepcache_interval", 1), kw.get("cfg_cache_interval", 1)
    k = max(deep, cfg)
    plan = []
    for idx in range(STEPS):
        if k > 1 and idx % k:
            plan.append(("shallow" if deep > 1 else "full", 1 if cfg > 1 else 2))
        else:
            plan += [("full", 2)] * kw.get("multidiff_total_steps", 1)
    return plan


def expected_launches(kw: dict, camera_kind, frames: int) -> dict:
    """Each kernel's launches in one request: its forwards' (PER_FORWARD or
    PER_SHALLOW), the pose encoder's with a camera, and the decoder's per
    call of k frames, k the largest divisor of the frames <= decode_chunk."""
    k = min(kw.get("decode_chunk", 1), frames)
    while frames % k:
        k -= 1
    out = Counter()
    for kind, _ in forward_plan(kw):
        out.update(PER_FORWARD if kind == "full" else PER_SHALLOW)
    if camera_kind is not None:
        out.update(PER_REQUEST)
    for _ in range(frames // k):
        out.update(PER_DECODE)
    return {name: out[name] for name in counters()}


def serve_once(pipe, i: int, request) -> tuple[dict, dict]:
    """REQUESTS[i] at full width through AnimationPipeline.__call__: the
    output's shape, finite values in [0, 1], the UNet forwards by kind and
    batch against ``forward_plan`` and each kernel's launches exactly.
    Returns the launches and the timings: ms per denoise step (CUDA events
    from the first forward on), s/clip, K1-K3 launches per step, peak."""
    label, prompt, cam, objs, kw = request
    dev = pipe.device
    overlap = kw.get("multidiff_overlaps", 0)
    frames = kw.get("multidiff_total_steps", 1) * (FRAMES - overlap) + overlap
    gen = torch.Generator(device=dev).manual_seed(100 + i)
    forwards, events, step_launches = [], [], []

    def on_step(idx, t):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        step_launches.append(sum(fn.launches for fn in counters().values()))

    def pre_hook(module, args, kwargs):
        if not forwards:  # the loop starts with its first forward
            on_step(None, None)
        forwards.append(("shallow" if kwargs.get("deep_cache") is not None else "full",
                         args[0].shape[0]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    hook = pipe.unet.register_forward_pre_hook(pre_hook, with_kwargs=True)
    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            traj = object_traj(pipe, seed=200 + i) if objs else None
            video = pipe(prompt, video_length=FRAMES, height=HEIGHT, width=WIDTH,
                         num_inference_steps=STEPS, guidance_scale=GUIDANCE, generator=gen,
                         plucker=plucker(pipe, cam, frames) if cam else None,
                         traj_features=traj, omcm_min_step=OMCM, on_step=on_step, **kw)
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
    finally:
        hook.remove()
    got = {k: fn.launches for k, fn in counters().items()}
    want = expected_launches(kw, cam, frames)
    if forwards != forward_plan(kw):
        raise AssertionError(f"request {label}: UNet forwards {forwards} != {forward_plan(kw)}")
    if got != want:
        raise AssertionError(f"request {label}: launches {got} != expected {want}")
    if tuple(video.shape) != (1, frames, HEIGHT, WIDTH, 3):
        raise AssertionError(f"request {label}: output shape {tuple(video.shape)}")
    if not bool(torch.isfinite(video).all()) or video.min() < 0 or video.max() > 1:
        raise AssertionError(f"request {label}: output not finite in [0, 1]")
    steps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return got, dict(ms_per_step=statistics.mean(steps), steps_ms=steps, clip_s=clip_s,
                     launches_per_step=[b - a for a, b in zip(step_launches, step_launches[1:])],
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30, forwards=forwards,
                     frames=frames, mean_pixel=video.float().mean().item())


def serve(pipe, card: str):
    """Each of REQUESTS twice (the first run of a mode meets its shapes for
    the first time); the second run's timings are the mode's."""
    launches, per_mode = Counter(), {}
    for i, request in enumerate(REQUESTS):
        for run in ("first", "second"):
            got, m = serve_once(pipe, i, request)
            launches.update(got)
            log(f"  request {request[0]} ({run} run): {m['frames']} frames, "
                f"{m['ms_per_step']:.2f} ms per denoise step (steps "
                f"{['%.1f' % x for x in m['steps_ms']]}), {m['clip_s']:.2f} s/clip, K1-K3 "
                f"launches per step {m['launches_per_step']}, forwards {m['forwards']}, "
                f"launches {got}, peak {m['peak_gib']:.2f} GiB, mean pixel "
                f"{m['mean_pixel']:.4f}; {card}")
        per_mode[request[0]] = m
    return launches, per_mode


OP_ROUTE_SHARE = 0.01  # the op route's host cost a step, as a share of the step, above
# which eager calls go straight to the implementations (ops/_library.py)


def _host_us(fn, args, n: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to issue, the device kept busy
    behind a sleep so that no call waits on it."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * 0.05))
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def op_route_cost(seen, ms_per_step: float, card: str) -> dict:
    """The host cost of reaching each forward kernel through its registered
    op (torch.ops.synfmc.*, the dispatcher) against a direct call of the same
    implementation, at request (a)'s most frequent key of each kernel (the
    UNet forward's), alternating the two routes 7 times, 50 calls each; the
    difference times the kernel's launches a step (PER_FORWARD) beside
    request (a)'s ms per step."""
    from synfmc_tpu_torch.ops import _library

    names = {"flash": "flash_attention_fwd", "temporal": "temporal_attention_fwd",
             "group_norm": "fused_group_norm_fwd"}
    gen = torch.Generator(device="cuda").manual_seed(9)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    rows, total_ms = {}, 0.0
    for kind, name in names.items():
        key = max((k for k in seen[kind] if k[0] == "unet"), key=lambda k: seen[kind][k])
        if kind == "group_norm":
            _, n, sl, c, groups, eps, act = key
            args = (rnd(n, sl, c), rnd(c), rnd(c), groups, float(eps), act)
        else:
            _, b, sl, c, heads, scale = key
            args = tuple(rnd(b, sl, c) for _ in range(3)) + (float(scale), heads)
            args += (False,) if kind == "flash" else ()
        impl, op = _library.IMPLS[name]["cuda"], _library.op(name)
        for fn in (op, impl):  # warm both
            fn(*args)
        times = {"op": [], "direct": []}
        for _ in range(7):
            times["op"].append(_host_us(op, args))
            times["direct"].append(_host_us(impl, args))
        op_us, direct_us = (statistics.median(times[k]) for k in ("op", "direct"))
        step_ms = (op_us - direct_us) * PER_FORWARD[kind] / 1e3
        total_ms += step_ms
        rows[kind] = dict(key=list(key[1:]), op_us=op_us, direct_us=direct_us,
                          per_step=PER_FORWARD[kind], step_ms=step_ms)
    share = total_ms / ms_per_step
    route = "eager calls the implementations directly" if share > OP_ROUTE_SHARE \
        else "the op route would do"
    log(f"[main] op route against a direct call, host us a call (median of 7 x 50): "
        f"{json.dumps(rows)}; {total_ms:.3f} ms a step of request (a)'s {ms_per_step:.2f} ms "
        f"({100 * share:.2f} %; limit {100 * OP_ROUTE_SHARE:.0f} %): {route}; {card}")
    return dict(rows=rows, step_ms=total_ms, share=share)


# ---------------------------------------------------------------------------
# phase entry: the user's entry points at full width, from reference-layout files
# ---------------------------------------------------------------------------

ENTRY_PROMPT = "a turtle paddles through a coral reef, seen from above!"
ENTRY_SEED = 21
ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
# A coalesced group of two requests: the UNet forwards at batch 4, the pose
# encoder once at batch 2, and 2 x FRAMES single-frame decodes.
GROUP_LAUNCHES = {k: STEPS * PER_FORWARD.get(k, 0) + PER_REQUEST.get(k, 0)
                  + 2 * FRAMES * PER_DECODE.get(k, 0) for k in ("flash", "temporal", "group_norm")}


def write_safetensors(path: str, tensors: dict) -> int:
    """A safetensors file, by this script's own writer: the u64 header
    length, the JSON header (padded to 8 bytes), each tensor's row-major
    bytes in order.  Returns the file's size."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little") + head)
        for t in tensors.values():
            fh.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())
    return os.path.getsize(path)


def write_tokenizer(folder: str, corpus, n_merges: int = 400) -> None:
    """A synthetic byte-level BPE vocabulary in CLIP's layout: the 256 byte
    symbols, the same with ``</w>``, the symbols of ``n_merges`` merges learnt
    greedily from ``corpus``, then <|startoftext|> and <|endoftext|>."""
    from synfmc_tpu_torch.data.tokenizer import bytes_to_unicode

    os.makedirs(folder)
    b2u = bytes_to_unicode()
    vocab = list(b2u.values()) + [c + "</w>" for c in b2u.values()]
    words = Counter()
    for line in corpus:
        for w in line.lower().split():
            sym = [b2u[b] for b in w.encode()]
            words[tuple(sym[:-1]) + (sym[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        vocab.append(best[0] + best[1])
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(folder, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump({t: i for i, t in enumerate(vocab)}, fh, ensure_ascii=False)
    with open(os.path.join(folder, "merges.txt"), "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")


def camera_label_text(kind: str = "pan", frames: int = FRAMES) -> str:
    """``camera(kind)`` as a camera label file (save_camera_info_txt layout)."""
    intr, c2w = camera(kind, frames=frames)
    lines = [str(frames)]
    for i in range(frames):
        vals = [float(v) for v in intr[0, i]] + [0.0, 0.0] + [float(v) for v in c2w[0, i, :3].reshape(-1)]
        lines.append(" ".join([str(i)] + [repr(v) for v in vals]))
    return "\n".join(lines) + "\n"


def write_reference_files(pipe, root: str) -> dict:
    """Every file the entry points read, from ``pipe``'s weights (bf16), in
    the reference layout: an SD1.5 diffusers directory (UNet spatial keys and
    VAE as safetensors, the text encoder as pytorch_model.bin, a BPE
    tokenizer), an AnimateDiff motion-module checkpoint (with its PE tables),
    the stage-1 LoRA, stage-2 CMC and stage-3 OMC bundles, a copy of
    configs/obj.yaml pointing at them, a camera file and an object npz."""
    import yaml

    unet = pipe.unet.state_dict()
    sd = os.path.join(root, "sd15")
    for sub in ("unet", "vae", "text_encoder"):
        os.makedirs(os.path.join(sd, sub))
    sizes = {
        "unet": write_safetensors(
            os.path.join(sd, "unet", "diffusion_pytorch_model.safetensors"),
            {k: v for k, v in unet.items() if "motion_modules" not in k and ".processor." not in k}),
        "vae": write_safetensors(os.path.join(sd, "vae", "diffusion_pytorch_model.safetensors"),
                                 pipe.vae.state_dict()),
    }
    cpu = lambda d: {k: v.detach().to("cpu").contiguous() for k, v in d.items()}
    paths = {"text": os.path.join(sd, "text_encoder", "pytorch_model.bin"),
             "mm": os.path.join(root, "mm_sd_v15_v3.ckpt"), "lora": os.path.join(root, "lora.ckpt"),
             "cmc": os.path.join(root, "cmcm.ckpt"), "omcm": os.path.join(root, "omcm.ckpt")}
    torch.save(cpu(pipe.text_encoder.state_dict()), paths["text"])
    write_tokenizer(os.path.join(sd, "tokenizer"), [r[1] for r in REQUESTS] + [ENTRY_PROMPT])
    motion = cpu({k: v for k, v in unet.items() if "motion_modules" in k and ".processor." not in k})
    for k in [k for k in motion if re.search(r"attention_blocks\.\d+\.to_q\.weight$", k)]:
        motion[k.replace("to_q.weight", "pos_encoder.pe")] = torch.zeros(1, 32, motion[k].shape[1])
    torch.save({"state_dict": motion}, paths["mm"])
    torch.save({"epoch": 1, "global_step": 1000, "optimizer_state_dict": None,
                "lora_state_dict": cpu({k: v for k, v in unet.items() if "_lora." in k})},
               paths["lora"])
    torch.save({"epoch": 2, "global_step": 2000, "optimizer_state_dict": None,
                "pose_encoder_state_dict": cpu(pipe.pose_encoder.state_dict()),
                "attention_processor_state_dict": cpu({k: v for k, v in unet.items()
                                                       if "_merge." in k})}, paths["cmc"])
    torch.save({"epoch": 3, "global_step": 3000, "optimizer_state_dict": None,
                "omcm_state_dict": cpu(pipe.adapter.state_dict())}, paths["omcm"])
    with open(OBJ_YAML) as fh:
        cfg = yaml.safe_load(fh)
    cfg.update(pretrained_model_path=sd, motion_module_ckpt=paths["mm"], lora_ckpt=paths["lora"],
               pretrained_cm_path=paths["cmc"], strict_pretrained=True)
    paths["config"] = os.path.join(root, "obj.yaml")
    with open(paths["config"], "w") as fh:
        yaml.safe_dump(cfg, fh)
    paths["camera"] = os.path.join(root, "camera.txt")
    with open(paths["camera"], "w") as fh:
        fh.write(camera_label_text())
    info, masks = objects(31, FRAMES, HEIGHT, WIDTH)
    paths["objects"] = os.path.join(root, "objects.npz")
    np.savez(paths["objects"], obj_info=info[0], obj_masks=masks[0])
    for key in ("text", "mm", "lora", "cmc", "omcm"):
        sizes[key] = os.path.getsize(paths[key])
    paths["sizes"] = sizes
    return paths


def gif_blocks(data: bytes) -> dict:
    """Walk a GIF89a's blocks (this script's own reader): the screen size, the
    NETSCAPE2.0 loop count, each Graphic Control Extension's delay and each
    image's size; raises on anything else."""
    if data[:6] != b"GIF89a":
        raise AssertionError(f"not a GIF89a: {data[:6]!r}")
    u16 = lambda i: int.from_bytes(data[i:i + 2], "little")
    out = dict(width=u16(6), height=u16(8), loop=None, delays=[], images=[])
    pos = 13 + (3 * (2 << (data[10] & 7)) if data[10] & 0x80 else 0)

    def sub_blocks(pos):
        chunks = []
        while data[pos]:
            chunks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        return chunks, pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            chunks, pos = sub_blocks(pos + 2)
            if label == 0xFF and chunks[0] == b"NETSCAPE2.0":
                out["loop"] = int.from_bytes(chunks[1][1:3], "little")
            elif label == 0xF9:
                out["delays"].append(int.from_bytes(chunks[0][1:3], "little"))
        elif data[pos] == 0x2C:
            out["images"].append((u16(pos + 5), u16(pos + 7)))
            flags = data[pos + 9]
            pos += 10 + (3 * (2 << (flags & 7)) if flags & 0x80 else 0)
            _, pos = sub_blocks(pos + 1)  # the LZW minimum code size, then the data
        else:
            raise AssertionError(f"unexpected GIF block 0x{data[pos]:02x} at {pos}")
    if pos != len(data) - 1:
        raise AssertionError(f"{len(data) - 1 - pos} bytes after the GIF trailer")
    return out


def check_gif(data: bytes, what: str, frames: int = FRAMES) -> dict:
    g = gif_blocks(data)
    want = dict(width=WIDTH, height=HEIGHT, loop=0, delays=[round(100 / 8)] * frames,
                images=[(WIDTH, HEIGHT)] * frames)
    if g != want:
        raise AssertionError(f"{what}: GIF blocks {dict((k, g[k]) for k in ('width', 'height', 'loop'))}, "
                             f"{len(g['images'])} images, delays {set(g['delays'])}")
    return g


class Daemon:
    """``python -m synfmc_tpu_torch.scripts.serve`` as a child process, its
    output collected line by line."""

    def __init__(self, args):
        import threading

        self.proc = subprocess.Popen([sys.executable, "-m", "synfmc_tpu_torch.scripts.serve",
                                      *args], cwd=REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, pattern: str, timeout: float = 600.0, n: int = 1):
        """Every match of ``pattern`` in the log once there are ``n`` (two
        handler threads may print onto one line)."""
        end = time.time() + timeout
        while time.time() < end:
            found = [m for line in list(self.lines) for m in re.finditer(pattern, line)]
            if len(found) >= n:
                return found
            if self.proc.poll() is not None:
                break
            time.sleep(0.2)
        raise AssertionError(f"serve: no {pattern!r}; its log:\n" + "\n".join(self.lines[-40:]))

    def close(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.reader.join(timeout=10)


def http(port: int, path: str, body=None, timeout: float = 600.0):
    """(status, content type, bytes, seconds) of one request to the daemon."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read(), time.perf_counter() - t0


def run_generate(paths: dict, card: str) -> dict:
    """The command-line program as a user runs it, to a GIF and the frames."""
    out, frames = (os.path.join(os.path.dirname(paths["config"]), n)
                   for n in ("clip.gif", "frames.npz"))
    cmd = [sys.executable, "-m", "synfmc_tpu_torch.scripts.generate", "--config", paths["config"],
           "--prompt", ENTRY_PROMPT, "--omcm-ckpt", paths["omcm"],
           "--camera-txt", paths["camera"], "--obj-traj-npz", paths["objects"],
           "--num-inference-steps", str(STEPS), "--video-length", str(FRAMES),
           "--guidance-scale", str(GUIDANCE), "--seed", str(ENTRY_SEED), "--out", out,
           "--save-frames", frames]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"generate: rc {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("# generate:"))
    nums = dict(re.findall(r"(load|denoise|decode) ([\d.]+) s", line))
    gif_ms, gif_bytes = re.search(r"gif ([\d.]+) ms \((\d+) bytes\)", line).groups()
    peak = float(re.search(r"peak ([\d.]+) GiB", line).group(1))
    launches = ast.literal_eval(re.search(r"launches (\{.*\})", line).group(1))
    with open(out, "rb") as fh:
        check_gif(fh.read(), "generate")
    want = {k: v for k, v in expected_launches({}, "pan", FRAMES).items() if k in launches}
    if launches != want:
        raise AssertionError(f"generate: launches {launches} != {want}")
    log(f"  generate: {wall:.2f} s from start to file ({out}); in process: load {nums['load']} s, "
        f"denoise {nums['denoise']} s ({STEPS} steps), decode {nums['decode']} s, GIF encode "
        f"{gif_ms} ms ({gif_bytes} bytes, {FRAMES} frames {WIDTH}x{HEIGHT}, loop 0, delay 12 cs), "
        f"peak {peak:.2f} GiB, launches {launches}; {card}")
    return dict(wall_s=wall, load_s=float(nums["load"]), denoise_s=float(nums["denoise"]),
                decode_s=float(nums["decode"]), gif_ms=float(gif_ms), gif_bytes=int(gif_bytes),
                peak_gib=peak, launches=launches, frames=frames)


def run_serve(paths: dict, card: str) -> dict:
    """The daemon on the same files: /healthz, two pairs of concurrent
    requests (each pair one bucket of 2), a camera of the wrong length."""
    import threading

    daemon = Daemon(["--config", paths["config"], "--omcm-ckpt", paths["omcm"], "--port", "0",
                     "--max-batch", "2", "--batch-window", "2", "--warmup",
                     "--num-inference-steps", str(STEPS), "--video-length", str(FRAMES)])
    t0 = time.perf_counter()
    try:
        port = int(daemon.wait_for(r"listening on 127\.0\.0\.1:(\d+)")[0].group(1))
        start_s = time.perf_counter() - t0
        code, _, body, _ = http(port, "/healthz")
        health = json.loads(body)
        if code != 200 or health.get("backend") != "cuda" or health.get("stage") != "obj":
            raise AssertionError(f"serve: /healthz {code} {health}")
        cam = camera_label_text()
        latencies = []
        for pair in range(2):
            results = [None, None]

            def ask(i):
                results[i] = http(port, "/generate", {
                    "prompt": REQUESTS[i][1], "seed": 300 + 10 * pair + i, "camera_txt": cam,
                    "num_inference_steps": STEPS, "video_length": FRAMES,
                    "guidance_scale": GUIDANCE})

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
                if t.is_alive():
                    raise AssertionError("serve: a request did not come back")
            for i, (code, ctype, data, secs) in enumerate(results):
                if code != 200 or ctype != "image/gif":
                    raise AssertionError(f"serve: request {pair}.{i}: {code} {data[:300]!r}")
                check_gif(data, f"serve request {pair}.{i}")
                latencies.append(secs)
        groups = daemon.wait_for(r"batched 2 request\(s\), 2 sample\(s\) -> bucket 2, "
                                 r"launches (\{[^}]*\}) in ([\d.]+)s", n=2)
        if len(groups) != 2:
            raise AssertionError(f"serve: {len(groups)} coalesced groups of 2, want 2")
        for m in groups:
            got = ast.literal_eval(m.group(1))
            if got != GROUP_LAUNCHES:
                raise AssertionError(f"serve: group launches {got} != {GROUP_LAUNCHES}")
        code, _, body, _ = http(port, "/generate", {"prompt": "x",
                                                    "camera_txt": camera_label_text("pan", 15)})
        if code != 400 or b"poses but video_length" not in body:
            raise AssertionError(f"serve: a 15-pose camera for 16 frames answered {code} {body!r}")
        served = daemon.wait_for(r"generated 1 clip\(s\) x 16f in ([\d.]+)s \(gif ([\d.]+) ms, "
                                 r"(\d+) bytes, peak ([\d.]+) GiB\)", n=4)
    finally:
        daemon.close()
    group_s = [float(m.group(2)) for m in groups]
    peak = max(float(m.group(4)) for m in served)
    gif_ms = [float(m.group(2)) for m in served]
    log(f"  serve: listening {start_s:.1f} s after start (warmup included); /healthz backend "
        f"cuda; 2 pairs of concurrent requests, each pair one bucket of 2: group pipeline "
        f"{['%.3f' % s for s in group_s]} s, per-request latency (client, 2 s batch window "
        f"included) {['%.3f' % s for s in latencies]} s, GIF encode "
        f"{['%.1f' % s for s in gif_ms]} ms, {served[0].group(3)} bytes, peak {peak:.2f} GiB; "
        f"the 15-pose camera answered 400; {card}")
    for line in daemon.lines:
        if "Traceback" in line or "Error" in line:
            log(f"  serve log: {line}")
    return dict(start_s=start_s, group_s=group_s, latency_s=latencies, gif_ms=gif_ms,
                peak_gib=peak, launches=sum((Counter(ast.literal_eval(m.group(1))) for m in groups),
                                            Counter()))


def entry(pipe, card: str) -> Counter:
    """Phase entry: write the reference-layout files from ``pipe``'s weights,
    build the obj stage from them (every parameter bit for bit), run the
    command-line program and the daemon on them as a user would, and hold the
    command line's frames to an in-process run.  Returns the launches of the
    entry paths (the program's and the daemon's as they log them, and the
    in-process run's)."""
    import shutil
    import tempfile

    from synfmc_tpu_torch.data.tokenizer import CLIPTokenizer
    from synfmc_tpu_torch.evaluation.metrics import parse_camera_txt
    from synfmc_tpu_torch.pipelines.factory import build_pipeline
    from synfmc_tpu_torch.scripts.generate import camera_plucker, object_features

    root = tempfile.mkdtemp(prefix="synfmc_entry_")
    try:
        t0 = time.perf_counter()
        paths = write_reference_files(pipe, root)
        sizes = paths["sizes"]
        log(f"  files written in {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in sizes.items())
            + f" ({sum(sizes.values()) / 2**30:.2f} GiB)")

        t0 = time.perf_counter()
        loaded = build_pipeline(paths["config"], stage="obj", cm_ckpt=paths["cmc"],
                                omcm_ckpt=paths["omcm"], seed=ENTRY_SEED)[0]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if not isinstance(loaded.tokenizer, CLIPTokenizer):
            raise AssertionError(f"entry: tokenizer {type(loaded.tokenizer).__name__}")
        n = 0
        for name in ("unet", "vae", "text_encoder", "pose_encoder", "adapter"):
            src = dict(getattr(pipe, name).named_parameters())
            got = dict(getattr(loaded, name).named_parameters())
            bad = [k for k, p in got.items() if not torch.equal(p, src[k])]
            if set(got) != set(src) or bad:
                raise AssertionError(f"entry: {name}: {len(bad)} parameters differ from the "
                                     f"files' source, e.g. {bad[:3]}")
            n += len(got)
        log(f"  build_pipeline from the files: {load_s:.2f} s, {n} parameters equal to their "
            f"source bit for bit (seed {ENTRY_SEED} for anything unloaded), tokenizer "
            f"CLIPTokenizer; {card}")

        cli = run_generate(paths, card)
        srv = run_serve(paths, card)

        # the command line's request, in process on the loaded pipeline
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True  # a fresh process's default
        for fn in counters().values():
            fn.launches = 0
        try:
            video = loaded([ENTRY_PROMPT], video_length=FRAMES, height=HEIGHT, width=WIDTH,
                           num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                           generator=torch.Generator(device="cuda").manual_seed(ENTRY_SEED),
                           plucker=camera_plucker((HEIGHT, WIDTH), 1, FRAMES,
                                                  parse_camera_txt(paths["camera"]), "cuda"),
                           traj_features=object_features(loaded, paths["objects"], 1),
                           omcm_min_step=OMCM)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        inproc = Counter({k: fn.launches for k, fn in counters().items()})
        if dict(inproc) != expected_launches({}, "pan", FRAMES):
            raise AssertionError(f"entry: in-process launches {dict(inproc)}")
        with np.load(cli["frames"]) as saved:
            ids, frames = saved["input_ids"], saved["video"]
        if ids.tolist() != loaded.tokenizer([ENTRY_PROMPT]).tolist():
            raise AssertionError("entry: the command line's token ids differ from in-process ones")
        err = float(np.abs(frames - video.float().cpu().numpy()).max())
        log(f"  in-process run of the command line's request: token ids equal "
            f"({int((ids[0] != loaded.tokenizer.pad_id).sum())} before padding), frames max abs "
            f"diff {err:.3e} (limit {LATENT_TOL}); launches {dict(inproc)}")
        if not err < LATENT_TOL:
            raise AssertionError(f"entry: command-line frames differ by {err}")
        del loaded
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = Counter(cli["launches"]) + srv["launches"] + inproc
    log(f"[entry] per clip: command line {cli['wall_s']:.2f} s wall (load {cli['load_s']:.2f}, "
        f"denoise {cli['denoise_s']:.3f}, decode {cli['decode_s']:.3f}, GIF {cli['gif_ms']:.1f} ms, "
        f"{cli['gif_bytes']} bytes, peak {cli['peak_gib']:.2f} GiB); daemon group of 2 "
        f"{srv['group_s']} s, latencies {['%.3f' % s for s in srv['latency_s']]} s, peak "
        f"{srv['peak_gib']:.2f} GiB; in-process build {load_s:.2f} s; {card}")
    return total


# ---------------------------------------------------------------------------
# phase 7: the stage-2 train step at full width
# ---------------------------------------------------------------------------


def train_main(profile: bool):
    """train("cam", configs/cam.yaml) on seeded synthetic batches for
    TRAIN_STEPS steps (one more, traced, with --profile), with the kernel
    shapes recorded for phase 8; its run directory (the end-of-run
    checkpoint) goes to a temporary directory, deleted after."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from synfmc_tpu_torch.training.trainers import train

    kernels = counters()
    per_step, grad_flags, traced = [], [], {}

    def on_step(state, metrics, draws):
        per_step.append({k: fn.launches for k, fn in kernels.items()})
        for fn in kernels.values():
            fn.launches = 0
        # a finite, non-zero gradient for every trainable tensor at the first
        # step after step 1 that kept the camera: the pose merges start at
        # zero (the JAX package's init), so at step 1 the pose encoder's
        # gradients are rightly zero, and a camera CFG dropout zeroes the
        # Plücker input and so its first layers' gradients
        if not grad_flags and state.step >= 2 and not bool(draws.camera_drop.any()):
            grad_flags.extend(
                (n, p.grad is not None and bool(torch.isfinite(p.grad).all())
                 and bool(p.grad.abs().max() > 0)) for n, p in state.trainable.items())
            grad_flags.insert(0, ("step", state.step))
        if profile and state.step == TRAIN_STEPS:
            torch.cuda.synchronize()
            traced["prof"] = torch_profile(activities=[ProfilerActivity.CUDA])
            traced["prof"].start()
            traced["t0"] = time.perf_counter()
        elif profile and state.step == TRAIN_STEPS + 1:
            torch.cuda.synchronize()
            traced["ms"] = (time.perf_counter() - traced["t0"]) * 1e3
            traced["prof"].stop()

    import shutil
    import tempfile

    import yaml

    with open(CAM_YAML) as fh:
        cfg = yaml.safe_load(fh)
    cfg["output_dir"] = tempfile.mkdtemp(prefix="synfmc_train_")  # its end-of-run checkpoint
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    try:
        with Recorder("train") as rec:
            out = train("cam", cfg, synthetic_batches(0), TRAIN_STEPS + int(profile), seed=0,
                        on_step=on_step)
    finally:
        shutil.rmtree(cfg["output_dir"], ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    if not grad_flags:
        raise AssertionError("train: every step dropped the camera")
    (_, grad_step), grad_flags = grad_flags[0], grad_flags[1:]
    bad = [n for n, ok in grad_flags if not ok]
    if not grad_flags or bad:
        raise AssertionError(f"train: step-{grad_step} gradients missing, non-finite or zero: "
                             f"{bad[:10]}")
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"train: losses {out['losses']}")
    (t0, t1), (f0, f1) = out["checksums"]["trainable"], out["checksums"]["frozen"]
    if t0 == t1 or f0 != f1:
        raise AssertionError(f"train: trainable checksum {t0} -> {t1}, frozen {f0} -> {f1}")
    for i, got in enumerate(per_step):
        if got != TRAIN_PER_STEP:
            raise AssertionError(f"train step {i + 1}: launches {got} != {TRAIN_PER_STEP}")
    ms = statistics.median(out["step_s"][1:TRAIN_STEPS]) * 1e3
    log(f"  losses {['%.4f' % x for x in out['losses']]}; step times "
        f"{['%.1f' % (t * 1e3) for t in out['step_s']]} ms; {len(grad_flags)} trainable tensors "
        f"with finite non-zero step-{grad_step} gradients; checksums trainable {t0:.6e} -> {t1:.6e}, "
        f"frozen {f0:.6e} -> {f1:.6e}")
    log(f"[train] {ms:.2f} ms per train step (median of steps 2-{TRAIN_STEPS}), peak "
        f"{peak / 2**30:.2f} GiB, trainable params {out['trainable_params']:,} "
        f"(frozen {out['frozen_params']:,}), launches per step {per_step[0]}")
    if profile:
        busy_ms, span_ms, n_kernels, families = device_spans(traced["prof"], 1)
        prof = {"traced_ms_per_step": traced["ms"], "untraced_ms_per_step": ms,
                "device_busy_ms_per_step": busy_ms, "kernels_per_step": n_kernels,
                "idle_share_traced": 1 - busy_ms / span_ms,
                "idle_share_estimate_untraced": 1 - busy_ms / ms,
                "families_ms_per_step": families}
        log(f"[profile] one train step: {json.dumps(prof)}")
    train_launches = Counter()
    for got in per_step:
        train_launches.update(got)
    steps = len(per_step)
    seen = {k: Counter({key: n // steps for key, n in v.items()}) for k, v in rec.seen.items()}
    return dict(ms=ms, peak=peak, launches=train_launches, seen=seen,
                trainable=out["trainable_params"], losses=out["losses"])


# ---------------------------------------------------------------------------
# phase train-files: the trainer from files, as a user runs it
# ---------------------------------------------------------------------------

FILES_STEPS, FILES_RESUME_AT = 4, 2
TRAIN_FILES_HEAD = (
    f"[train-files] python -m synfmc_tpu_torch.scripts.train --stage cam on a fixture dataset "
    f"and reference-layout files: batch 1, {FRAMES} frames {HEIGHT}x{WIDTH}, bf16 with fp32 "
    f"masters, {FILES_STEPS} steps; {FILES_RESUME_AT} steps, then resume_from: auto to "
    f"{FILES_STEPS}; checkpointing_steps 2")
# The dataset fixture: 4 sequences of 65 frames at twice the sample size, so
# that the loader's resample really downsizes.  Its object masks are 14x14
# squares, under the dataset's default visibility threshold (0.15 % of a
# 512x768 frame, 590 px), so the config lowers the threshold to 0.04 %.
FIXTURE = dict(num_seqs=4, num_objects=N_OBJECTS, num_frames=64, height=2 * HEIGHT,
               width=2 * WIDTH)
APPEARANCE = 0.0004
# Losses after the resume against the uninterrupted run's, relative.  The
# restored state is checked bit for bit; the two runs' states can still
# differ in the last bits after their first steps, as cuDNN's and cuBLAS's
# backward passes may reduce in another order from run to run, and the bf16
# forward turns that into a small loss difference.  A wrong batch, draw or
# step moves the loss by far more: the timestep alone changes it by tens of
# percent.
RESUME_LOSS_REL_TOL = 1e-2


def write_train_files(root: str) -> dict:
    """Everything the trainer reads, written by the port's own writers: a
    fixture dataset, the serving phase's weights (the same seed) as
    reference-layout files (SD1.5 directory, AnimateDiff motion modules,
    LoRA bundle; write_reference_files), and a copy of configs/cam.yaml
    naming them with checkpointing_steps 2.  Returns the paths and the
    source pipeline."""
    import yaml

    from synfmc_tpu_torch.data.fixture import build_synthetic_dataset
    from synfmc_tpu_torch.pipelines.factory import build_pipeline, randomize_pipeline_

    t0 = time.perf_counter()
    data = build_synthetic_dataset(os.path.join(root, "data"), **FIXTURE)
    fixture_s = time.perf_counter() - t0
    fixture_bytes = sum(os.path.getsize(os.path.join(d, f))
                        for d, _, fs in os.walk(os.path.join(root, "data")) for f in fs)
    pipe = randomize_pipeline_(build_pipeline(OBJ_YAML, stage="obj", seed=0,
                                              allow_untrained_cm=True)[0], 0)
    t0 = time.perf_counter()
    paths = write_reference_files(pipe, os.path.join(root, "files"))
    files_s = time.perf_counter() - t0
    with open(CAM_YAML) as fh:
        cfg = yaml.safe_load(fh)
    cfg.update(pretrained_model_path=os.path.join(root, "files", "sd15"),
               motion_module_ckpt=paths["mm"], lora_ckpt=paths["lora"], strict_pretrained=True,
               checkpointing_steps=2, logger_interval=1)
    cfg["train_data"]["params"].update(data, appearance_percentage=APPEARANCE)
    configs = {}
    for run, out, resume in (("a", "a", None), ("b", "b", None), ("c", "b", "auto")):
        run_cfg = dict(cfg, output_dir=os.path.join(root, "runs", out))
        if resume:
            run_cfg["resume_from"] = resume
        configs[run] = os.path.join(root, f"cam_{run}.yaml")
        with open(configs[run], "w") as fh:
            yaml.safe_dump(run_cfg, fh)
    return dict(configs=configs, config=cfg, data=data, pipe=pipe, fixture_s=fixture_s,
                fixture_bytes=fixture_bytes, files_s=files_s, sizes=paths["sizes"])


def run_train(config: str, steps: int, stage: str = "cam") -> dict:
    """``python -m synfmc_tpu_torch.scripts.train`` as a user runs it; its
    last line, the metrics dict, with the process's wall seconds."""
    cmd = [sys.executable, "-m", "synfmc_tpu_torch.scripts.train", "--stage", stage, "--config",
           config, "--max-steps", str(steps)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train-files: {' '.join(cmd[3:])}: rc {proc.returncode}\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    out = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = wall
    return out


def prepare_train_files(root: str) -> dict:
    """write_train_files into ``root``, logged."""
    w = write_train_files(root)
    log(f"  fixture {FIXTURE['num_seqs']} x {FIXTURE['num_frames'] + 1} frames at "
        f"{FIXTURE['height']}x{FIXTURE['width']}, {FIXTURE['num_objects']} objects, written "
        f"in {w['fixture_s']:.1f} s ({w['fixture_bytes'] / 2**20:.1f} MiB); reference files "
        f"in {w['files_s']:.1f} s ({sum(w['sizes'].values()) / 2**30:.2f} GiB)")
    return w


def train_files(card: str, root: str, w: dict) -> Counter:
    """Phase train-files: the stage-2 trainer from the files ``w`` (in
    ``root``) at full width, as child processes: FILES_STEPS steps
    uninterrupted (run a); FILES_RESUME_AT steps (b), then ``resume_from:
    auto`` to FILES_STEPS (c).  Checks the parameters loaded from the files
    bit for bit, the launches per step, the restored state bit for bit, the
    losses after the resume within RESUME_LOSS_REL_TOL, and that run a's last
    cmcm-step-N.ckpt loads into build_pipeline as pretrained_cm_path with the
    trainer's final pose encoder and merge weights.  Deletes its runs after;
    returns their launches."""
    import shutil

    from synfmc_tpu_torch.pipelines.factory import build_pipeline, cast_models_, init_models
    from synfmc_tpu_torch.training import checkpoint as ckpt
    from synfmc_tpu_torch.training.optim import make_optimizer
    from synfmc_tpu_torch.training.params import partition_params, stage2_cmc_unet_trainable
    from synfmc_tpu_torch.training.pretrained import load_pretrained
    from synfmc_tpu_torch.training.steps import init_train_state
    from synfmc_tpu_torch.training.trainers import checksum, restore_state

    try:
        cfg, pipe = w["config"], w.pop("pipe")

        # the trainer's load, in process: every tensor the files hold, bit for bit
        models = init_models(cfg, "cam", int(cfg["global_seed"]), "cuda")
        load_pretrained(models, cfg, "cam")
        cast_models_(models, torch.bfloat16)
        n = 0
        for name, src in (("unet", pipe.unet), ("vae", pipe.vae), ("text", pipe.text_encoder)):
            want = dict(src.named_parameters())
            got = {k: p for k, p in models[name].named_parameters()
                   if name != "unet" or "_merge." not in k}
            bad = [k for k, p in got.items() if not torch.equal(p, want[k])]
            if bad:
                raise AssertionError(f"train-files: {name}: {len(bad)} parameters differ from "
                                     f"the files' source, e.g. {bad[:3]}")
            n += len(got)
        del pipe
        trainable = {**partition_params(models["unet"], stage2_cmc_unet_trainable, "unet."),
                     **partition_params(models["pose_encoder"], lambda k: True, "pose_encoder.")}
        for name in ("vae", "text"):
            partition_params(models[name], lambda k: False)
        frozen_sum = checksum([p for m in models.values() for p in m.parameters()
                               if not p.requires_grad])
        log(f"  the trainer's load in process: {n} parameters equal to the files' source bit "
            f"for bit (the pose merges and the pose encoder are seeded)")

        runs = {"a": run_train(w["configs"]["a"], FILES_STEPS)}
        runs["b"] = run_train(w["configs"]["b"], FILES_RESUME_AT)
        runs["c"] = run_train(w["configs"]["c"], FILES_STEPS)
        total = Counter()
        for key, steps in (("a", FILES_STEPS), ("b", FILES_RESUME_AT),
                           ("c", FILES_STEPS - FILES_RESUME_AT)):
            r = runs[key]
            if r["steps"] != steps + (FILES_RESUME_AT if key == "c" else 0):
                raise AssertionError(f"train-files: run {key} took {r['steps']} steps")
            if not np.isfinite(r["losses"]).all() or len(r["losses"]) != steps:
                raise AssertionError(f"train-files: run {key} losses {r['losses']}")
            want = {k: v * steps for k, v in TRAIN_PER_STEP.items()}
            if r["launches"] != want:
                raise AssertionError(f"train-files: run {key} launches {r['launches']} != {want}")
            total.update(r["launches"])
            f0, f1 = r["checksums"]["frozen"]
            if not f0 == f1 == frozen_sum:
                raise AssertionError(f"train-files: run {key} frozen checksum {f0} -> {f1}, "
                                     f"the files' load {frozen_sum}")

        # the resume: run c restored run b's last state bit for bit
        saved = ckpt.restore_native(os.path.join(runs["b"]["run_dir"], "checkpoints",
                                                 f"step-{FILES_RESUME_AT}"))
        masters = {k: p.detach().float().clone() for k, p in trainable.items()}
        state = init_train_state(trainable, make_optimizer(float(cfg["learning_rate"])), masters)
        restore_state(state, saved)
        bad = [k for k in trainable if not torch.equal(state.masters[k].cpu(), saved["masters"][k])
               or not torch.equal(trainable[k], state.masters[k].to(trainable[k].dtype))]
        exp_avg, exp_avg_sq = state.optimizer.moments()
        bad += [k for k, m, v in zip(trainable, exp_avg, exp_avg_sq)
                if not (torch.equal(m.cpu(), saved["exp_avg"][k])
                        and torch.equal(v.cpu(), saved["exp_avg_sq"][k]))]
        restored_sum = checksum(trainable.values())
        if bad or restored_sum != runs["c"]["checksums"]["trainable"][0]:
            raise AssertionError(f"train-files: restore: {len(bad)} tensors differ ({bad[:3]}); "
                                 f"checksum {restored_sum} vs run c's "
                                 f"{runs['c']['checksums']['trainable'][0]}")
        want = np.asarray(runs["a"]["losses"][FILES_RESUME_AT:])
        got = np.asarray(runs["c"]["losses"])
        rel = np.abs(got - want) / np.abs(want)
        before = np.abs(np.asarray(runs["b"]["losses"]) - runs["a"]["losses"][:FILES_RESUME_AT])
        log(f"  resume: run c restored run b's step-{FILES_RESUME_AT} state bit for bit "
            f"({len(trainable)} masters, moments, count {saved['count']}; run c's checksum of "
            f"the working weights equal); losses a {['%.6f' % x for x in runs['a']['losses']]}, "
            f"b {['%.6f' % x for x in runs['b']['losses']]}, c {['%.6f' % x for x in got]}; "
            f"c vs a relative {['%.2e' % x for x in rel]} (limit {RESUME_LOSS_REL_TOL}); "
            f"b vs a before the resume: max abs {before.max():.3e}")
        if not (rel < RESUME_LOSS_REL_TOL).all():
            raise AssertionError(f"train-files: losses after the resume {got} vs {want}")
        del state, trainable, models, saved
        torch.cuda.empty_cache()

        # run a's last bundle through build_pipeline: the trainer's final weights
        a_dir = runs["a"]["run_dir"]
        final = ckpt.restore_native(os.path.join(a_dir, "checkpoints", f"step-{FILES_STEPS}"))
        bundle = os.path.join(a_dir, "checkpoints", f"cmcm-step-{FILES_STEPS}.ckpt")
        cm = build_pipeline(w["configs"]["a"], stage="cam", cm_ckpt=bundle,
                            seed=int(cfg["global_seed"]))[0]
        got = {**{"unet." + k: p for k, p in cm.unet.named_parameters() if "_merge." in k},
               **{"pose_encoder." + k: p for k, p in cm.pose_encoder.named_parameters()}}
        bad = [k for k, m in final["masters"].items()
               if not torch.equal(got[k].cpu(), m.to(got[k].dtype))]
        if set(got) != set(final["masters"]) or bad:
            raise AssertionError(f"train-files: cmcm-step-{FILES_STEPS}.ckpt through "
                                 f"build_pipeline: {len(bad)} tensors differ, e.g. {bad[:3]}")
        log(f"  cmcm-step-{FILES_STEPS}.ckpt as pretrained_cm_path: build_pipeline's pose "
            f"encoder and {sum('_merge.' in k for k in got)} merge tensors equal the trainer's "
            f"final weights ({len(got)} tensors)")
        del cm

        a, c = runs["a"], runs["c"]
        ms = lambda ts: ["%.1f" % (t * 1e3) for t in ts]
        ckpts = [(k["step"], k["path"], round(k["copy_s"], 3), round(k["writer_copy_s"], 3),
                  round(k["write_s"], 2), round(k["bytes"] / 2**30, 3)) for k in a["checkpoints"]]
        per_step = {k: v // FILES_STEPS for k, v in a["launches"].items()}
        log(f"[train-files] run a ({FILES_STEPS} steps, batch {cfg['train_batch_size']}, "
            f"{cfg['num_workers']} workers): process {a['process_s']:.1f} s, first step "
            f"{a['first_step_s']:.2f} s after train(); step "
            f"{statistics.median(a['step_s'][1:]) * 1e3:.1f} ms median of steps 2-{FILES_STEPS} "
            f"{ms(a['step_s'])}; data wait {ms(a['data_s'])} ms; checkpoints (step, path, s in "
            f"the loop, the writer's host copy s, write s, GiB) {ckpts}; peak {a['peak_gib']:.2f} GiB; launches per step "
            f"{per_step}; resume (run c): process {c['process_s']:.1f} s, first step "
            f"{c['first_step_s']:.2f} s after train(), data wait {ms(c['data_s'])} ms, peak "
            f"{c['peak_gib']:.2f} GiB; {card}")
        return total
    finally:
        shutil.rmtree(os.path.join(root, "runs"), ignore_errors=True)


# ---------------------------------------------------------------------------
# phase train-stages: stage 1 -> stage 2 -> stage 3 from files, as a user
# chains them
# ---------------------------------------------------------------------------

# Kernel launches of one train step at full width, by stage (batch 1 and
# 16 frames, or stage 1's 16 single frames).  Stage 1's UNet has no motion
# modules: K1 x10 and the mid block's 24-token self-attention on K2, each
# with its backward (every LoRA trains), and K3 x61 plus the VAE encoder's
# x22.  Stage 3 runs stage 2's forward; its backward starts at the first traj
# feature (after down_blocks[0]'s two layers) and skips the frozen pose
# encoder.  Remat runs the UNet's forward twice, the backward once.
LORA_PER_STEP = {"flash": 10, "flash_bwd": 10, "temporal": 1, "temporal_bwd": 1,
                 "group_norm": 83}
OBJ_PER_STEP = {"flash": 10, "flash_bwd": 8, "temporal": 49, "temporal_bwd": 37,
                "group_norm": 103}
OBJ_REMAT_PER_MICRO = {"flash": 20, "flash_bwd": 8, "temporal": 90, "temporal_bwd": 37,
                       "group_norm": 184}
LORA_YAML = os.path.join(REPO, "configs", "lora.yaml")
# Stage 1's batch of 16 clips needs 16 sequences; a clip gives one frame.
LORA_FIXTURE = dict(num_seqs=16, num_objects=N_OBJECTS, num_frames=8, height=2 * HEIGHT,
                    width=2 * WIDTH)
STAGE_STEPS = {"lora": 4, "cam": 3, "obj": 4}
OBJ_RESUME_AT = VALIDATION_STEP = ACCUM = 2
REMAT_STEPS = 3
TRAIN_STAGES_HEAD = (
    f"[train-stages] python -m synfmc_tpu_torch.scripts.train chained on the files: stage 1 "
    f"(configs/lora.yaml, batch 16 single frames {HEIGHT}x{WIDTH}, {STAGE_STEPS['lora']} steps, "
    f"validation at step {VALIDATION_STEP}) -> stage 2 (its LoRA, {STAGE_STEPS['cam']} steps) -> "
    f"stage 3 (configs/obj.yaml on that CMC bundle, {STAGE_STEPS['obj']} steps, validation at "
    f"step {VALIDATION_STEP}; resumed from step {OBJ_RESUME_AT}); then stage 3 with "
    f"gradient_accumulation_steps {ACCUM} and remat 'full' and 'dots' in process, "
    f"{REMAT_STEPS} steps each")


def _stage_models(config: dict, stage: str):
    """The stage's modules at full width on the card, bf16, every weight
    seeded (the structural zeros too, so that every path is live)."""
    from synfmc_tpu_torch.pipelines.factory import cast_models_, init_models, init_random_

    models = init_models(config, stage, 0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for module in models.values():
        init_random_(module, gen)
    return cast_models_(models, torch.bfloat16)


def _unreached_adapter_names(adapter) -> set:
    """The ObjectAdapter's last stage: its features go to the 4th down
    block, which takes none, so their gradient is zero in both packages."""
    last = len(adapter.body) // adapter.nums_rb - 1
    first = last * adapter.nums_rb
    return {"adapter." + n for n, _ in adapter.named_parameters()
            if n.startswith(f"zero_conv_out_list.{last}.")
            or any(n.startswith(f"body.{first + j}.") for j in range(adapter.nums_rb))}


def record_stage_shapes() -> dict:
    """Recorded, in process, at full width with seeded weights on synthetic
    batches: one stage-1 grads call at configs/lora.yaml's batch (16 single
    frames, 256x384), one stage-1 validation render (one prompt, F = 1, the
    CFG pair, 2 DDIM steps, a one-frame decode), one stage-3 grads call
    (configs/obj.yaml, batch 1, 16 frames, 3 objects).  Checks each grads
    call's launches against LORA_PER_STEP / OBJ_PER_STEP and a finite
    non-zero gradient for every trainable tensor (the ObjectAdapter's last
    stage: zero, as it reaches no loss).  Returns the recorder's keys by
    kernel."""
    import shutil
    import tempfile

    import yaml

    from synfmc_tpu_torch.data.tokenizer import HashTokenizer
    from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
    from synfmc_tpu_torch.training import steps as st
    from synfmc_tpu_torch.training.trainers import _trainable_set, step_config
    from synfmc_tpu_torch.training.validation import run_validation

    tok = HashTokenizer()
    gen = torch.Generator(device="cuda").manual_seed(5)
    seen = {}

    def merge(rec):
        for k, v in rec.seen.items():
            seen.setdefault(k, Counter()).update(v)

    def grads_check(stage, trainable, grads, allowed_zero=frozenset()):
        bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())
               or (n not in allowed_zero and not bool(g.abs().max() > 0))
               or (n in allowed_zero and bool(g.abs().max() > 0))]
        if bad or set(grads) != set(trainable):
            raise AssertionError(f"train-stages: {stage} gradients non-finite, zero or "
                                 f"unexpected: {bad[:10]}")
        return len(grads)

    with open(LORA_YAML) as fh:
        cfg = yaml.safe_load(fh)
    cfg["validation_data"].update(num=1, num_inference_steps=2)
    models = _stage_models(cfg, "lora")
    trainable = _trainable_set("lora", models, cfg)
    scfg = step_config(cfg, "lora")
    schedule = DiffusionSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    b = int(cfg["train_batch_size"])
    batch = {"pixel_values": torch.rand(b, HEIGHT, WIDTH, 3, device="cuda", generator=gen) * 2 - 1,
             "input_ids": torch.as_tensor(tok(["a red robot stands in a meadow"] * b),
                                          device="cuda").long(),
             "null_ids": torch.as_tensor(tok([""])[0], device="cuda").long()}
    grads_fn = st.make_lora_grads_fn(models["unet"], models["vae"], models["text"], schedule,
                                     scfg)
    draws = st.draw_lora(gen, batch, scfg, schedule)
    with Recorder("lora") as rec:
        grads, _ = grads_fn(trainable, batch, draws)
        torch.cuda.synchronize()
    n_lora = grads_check("lora", trainable, grads)
    merge(rec)
    del grads
    tmp = tempfile.mkdtemp(prefix="synfmc_val_")
    try:
        with Recorder("lora_val") as rec:
            files = run_validation("lora", tmp, 0, models, cfg, tok, schedule, device="cuda")
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if files != ["validation.png"]:
        raise AssertionError(f"train-stages: stage-1 validation wrote {files}")
    merge(rec)
    del models, trainable, grads_fn, batch
    torch.cuda.empty_cache()

    with open(OBJ_YAML) as fh:
        cfg = yaml.safe_load(fh)
    models = _stage_models(cfg, "obj")
    trainable = _trainable_set("obj", models, cfg)
    scfg = step_config(cfg, "obj")
    schedule = DiffusionSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    raw = next(synthetic_batches(7))
    batch = {k: torch.as_tensor(np.asarray(v), device="cuda") for k, v in raw.items()
             if k not in ("captions", "background_captions")}
    batch.update(pixel_values=batch["pixel_values"].float(),
                 input_ids=torch.as_tensor(tok(raw["captions"]), device="cuda").long(),
                 background_ids=torch.as_tensor(tok(raw["background_captions"]),
                                                device="cuda").long(),
                 null_ids=torch.as_tensor(tok([""])[0], device="cuda").long())
    info, masks = objects(11, FRAMES, HEIGHT, WIDTH)
    batch.update(obj_info=torch.as_tensor(info, device="cuda").float(),
                 obj_masks=torch.as_tensor(masks, device="cuda").float())
    grads_fn = st.make_obj_grads_fn(models["unet"], models["pose_encoder"], models["adapter"],
                                    models["vae"], models["text"], schedule, scfg)
    draws = st.draw_obj(gen, batch, scfg, schedule)
    draws.om_uniform.fill_(1.0)  # keep the objects: every adapter path live
    with Recorder("obj") as rec:
        grads, _ = grads_fn(trainable, batch, draws)
        torch.cuda.synchronize()
    n_obj = grads_check("obj", trainable, grads, _unreached_adapter_names(models["adapter"]))
    merge(rec)
    del models, trainable, grads_fn, batch, grads
    torch.cuda.empty_cache()

    for stage, want in (("lora", LORA_PER_STEP), ("obj", OBJ_PER_STEP)):
        got = {k: sum(n for key, n in v.items() if key[0] == stage) for k, v in seen.items()
               if k != "group_norm_bwd"}
        if got != want:
            raise AssertionError(f"train-stages: {stage} step launches {got} != {want}")
    val = {k: sum(n for key, n in v.items() if key[0] == "lora_val") for k, v in seen.items()}
    log(f"  recorded in process: a stage-1 step ({n_lora} LoRA tensors, finite non-zero "
        f"gradients; launches {LORA_PER_STEP}), a stage-1 validation render (launches {val}), "
        f"a stage-3 step ({n_obj} adapter tensors, finite gradients, zero exactly on the "
        f"adapter's last stage; launches {OBJ_PER_STEP})")
    return seen


def _new_keys(seen: dict, checked: set) -> dict:
    """The recorded keys whose shape (all but the stage label) no check has
    held yet, by kernel; each shape once."""
    out = {}
    for kind, keys in seen.items():
        fresh = Counter()
        for key, n in keys.items():
            if (kind, key[1:]) not in checked:
                checked.add((kind, key[1:]))
                fresh[key] = n
        out[kind] = fresh
    return out


def _write_yaml(path: str, cfg: dict) -> str:
    import yaml

    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def _check_run(name: str, r: dict, steps: int, per_step: dict, resumed_from: int = 0) -> None:
    if r["steps"] != steps or len(r["losses"]) != steps - resumed_from:
        raise AssertionError(f"train-stages: {name} took {r['steps']} steps "
                             f"({len(r['losses'])} losses)")
    if not np.isfinite(r["losses"]).all():
        raise AssertionError(f"train-stages: {name} losses {r['losses']}")
    want = {k: v * (steps - resumed_from) for k, v in per_step.items()}
    if r["launches"] != want:
        raise AssertionError(f"train-stages: {name} launches {r['launches']} != {want}")
    (t0, t1), (f0, f1) = r["checksums"]["trainable"], r["checksums"]["frozen"]
    if t0 == t1 or f0 != f1:
        raise AssertionError(f"train-stages: {name} trainable checksum {t0} -> {t1}, frozen "
                             f"{f0} -> {f1}")


def _check_validation(name: str, r: dict, want) -> float:
    log_txt = open(os.path.join(r["run_dir"], "log.txt")).read()
    v = r["validations"]
    if (len(v) != 1 or v[0]["step"] != VALIDATION_STEP or v[0]["error"]
            or re.search(r"validation at step \d+ failed", log_txt)):
        raise AssertionError(f"train-stages: {name} validation {v}")
    missing = [f for f in want if f not in v[0]["files"]]
    if missing:
        raise AssertionError(f"train-stages: {name} validation lacks {missing}: {v[0]['files']}")
    return v[0]["s"]


def _gib(x) -> str:
    return "not measured" if x is None else f"{x:.2f} GiB"


def _stage_line(name: str, r: dict, accum: int = 1) -> str:
    ms = statistics.median(r["step_s"][1:]) * 1e3
    val = (f", validation {r['validations'][0]['s']:.2f} s ({len(r['validations'][0]['files'])} "
           f"files, peak {_gib(r['validations'][0]['peak_gib'])})" if r["validations"] else "")
    ck = sum(c["bytes"] for c in r["checkpoints"])
    proc = f"process {r['process_s']:.1f} s, " if "process_s" in r else ""
    return (f"{name}: {proc}first step {r['first_step_s']:.2f} s after train(); "
            f"{ms:.1f} ms per {'optimizer ' if accum > 1 else ''}step (median of steps 2+; "
            f"{['%.1f' % (t * 1e3) for t in r['step_s']]}; data wait "
            f"{['%.1f' % (t * 1e3) for t in r['data_s']]}); peak {_gib(r['peak_gib'])}; "
            f"checkpoints {len(r['checkpoints'])}, {ck / 2**30:.3f} GiB{val}; trainable "
            f"{r['trainable_params']:,}")


def train_stages(card: str, root: str, w: dict, rates, traced, checked: set) -> tuple:
    """Phase train-stages: the three stages chained from the files ``w`` (in
    ``root``) as a user runs them, then accumulation with remat.  Records and
    checks the kernels at the stages' new shapes first (``checked``: the
    (kernel, shape) pairs already held).  Returns (launches, result rows)."""
    import shutil

    import yaml

    from synfmc_tpu_torch.data.fixture import build_synthetic_dataset
    from synfmc_tpu_torch.training import checkpoint as ckpt
    from synfmc_tpu_torch.training.trainers import train

    w.pop("pipe", None)
    torch.cuda.empty_cache()
    seen = record_stage_shapes()
    fresh = _new_keys(seen, checked)
    log(f"  kernels at the stages' shapes no earlier phase checked: "
        f"{ {k: len(v) for k, v in fresh.items()} }")
    results = check_kernels({k: fresh[k] for k in ("flash", "temporal", "group_norm")}, rates,
                            traced, fp32=False)
    results.update(check_bwd({k: fresh[k] for k in ("flash_bwd", "temporal_bwd")}, rates))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lora_data = build_synthetic_dataset(os.path.join(root, "lora_data"), **LORA_FIXTURE)
    log(f"  stage-1 fixture {LORA_FIXTURE['num_seqs']} x {LORA_FIXTURE['num_frames'] + 1} frames "
        f"written in {time.perf_counter() - t0:.1f} s; disk free "
        f"{shutil.disk_usage(root).free / 2**30:.1f} GiB")
    files = dict(pretrained_model_path=w["config"]["pretrained_model_path"],
                 strict_pretrained=True, logger_interval=1, checkpointing_steps=100)
    val = dict(enable_validation=True, validation_steps=-1,
               validation_steps_tuple=[VALIDATION_STEP])
    runs_dir = os.path.join(root, "stage_runs")
    total = Counter()

    with open(LORA_YAML) as fh:
        lora_cfg = yaml.safe_load(fh)
    lora_cfg.update(files, **val, output_dir=os.path.join(runs_dir, "lora"))
    lora_cfg["validation_data"].update(num=1, num_inference_steps=STEPS)
    lora_cfg["train_data"]["params"].update(lora_data, appearance_percentage=APPEARANCE)
    lora = run_train(_write_yaml(os.path.join(root, "stage_lora.yaml"), lora_cfg),
                     STAGE_STEPS["lora"], "lora")
    _check_run("stage 1", lora, STAGE_STEPS["lora"], LORA_PER_STEP)
    _check_validation("stage 1", lora, ["validation.png"])
    if not os.path.exists(os.path.join(lora["run_dir"], "sanity_check", "batch.png")):
        raise AssertionError("train-stages: stage 1 wrote no sanity_check/batch.png")
    lora_bundle = os.path.join(lora["run_dir"], "checkpoints",
                               f"lora-step-{STAGE_STEPS['lora']}.ckpt")

    cam_cfg = dict(w["config"], lora_ckpt=lora_bundle, checkpointing_steps=100,
                   output_dir=os.path.join(runs_dir, "cam"))
    cam = run_train(_write_yaml(os.path.join(root, "stage_cam.yaml"), cam_cfg),
                    STAGE_STEPS["cam"], "cam")
    _check_run("stage 2", cam, STAGE_STEPS["cam"], TRAIN_PER_STEP)
    cmc_bundle = os.path.join(cam["run_dir"], "checkpoints",
                              f"cmcm-step-{STAGE_STEPS['cam']}.ckpt")

    with open(OBJ_YAML) as fh:
        obj_cfg = yaml.safe_load(fh)
    obj_cfg.update(files, **val, motion_module_ckpt=w["config"]["motion_module_ckpt"],
                   lora_ckpt=lora_bundle, pretrained_cm_path=cmc_bundle,
                   checkpointing_steps=OBJ_RESUME_AT, output_dir=os.path.join(runs_dir, "obj_a"))
    obj_cfg["validation_data"].update(num=1, num_inference_steps=STEPS)
    obj_cfg["train_data"]["params"].update(w["data"], appearance_percentage=APPEARANCE)
    obj = run_train(_write_yaml(os.path.join(root, "stage_obj.yaml"), obj_cfg),
                    STAGE_STEPS["obj"], "obj")
    _check_run("stage 3", obj, STAGE_STEPS["obj"], OBJ_PER_STEP)
    _check_validation("stage 3", obj, ["real-0.gif", "cm-0.gif", "omcm-0.gif", "label_0.txt",
                                       "cam_label_compute_0.txt", "cam_label_gt_0.txt"]
                      + [f"0_masks/{i}.png" for i in range(FRAMES)]
                      + [f"0_real_masks/{i}.png" for i in range(FRAMES)])
    tools_evaluate(os.path.join(obj["run_dir"], "samples", str(VALIDATION_STEP)), card)
    for name, r, wanted in (("stage 2", cam, f"loaded stage-1 LoRA from {lora_bundle}"),
                            ("stage 3", obj, f"loaded stage-1 LoRA from {lora_bundle}"),
                            ("stage 3", obj, f"loaded stage-2 CMC from {cmc_bundle}")):
        if wanted not in open(os.path.join(r["run_dir"], "log.txt")).read():
            raise AssertionError(f"train-stages: {name}'s log lacks '{wanted}'")

    # the resume: from run a's step-2 state to its last step, bit for bit
    resume_cfg = dict(obj_cfg, enable_validation=False, output_dir=os.path.join(runs_dir, "obj_c"),
                      resume_from=os.path.join(obj["run_dir"], "checkpoints",
                                               f"step-{OBJ_RESUME_AT}"))
    resumed = run_train(_write_yaml(os.path.join(root, "stage_obj_c.yaml"), resume_cfg),
                        STAGE_STEPS["obj"], "obj")
    _check_run("stage 3 resumed", resumed, STAGE_STEPS["obj"], OBJ_PER_STEP, OBJ_RESUME_AT)
    want_losses = obj["losses"][OBJ_RESUME_AT:]
    a_end = ckpt.restore_native(os.path.join(obj["run_dir"], "checkpoints",
                                             f"step-{STAGE_STEPS['obj']}"))
    c_end = ckpt.restore_native(os.path.join(resumed["run_dir"], "checkpoints",
                                             f"step-{STAGE_STEPS['obj']}"))
    bad = [k for part in ("masters", "exp_avg", "exp_avg_sq") for k in a_end[part]
           if not torch.equal(a_end[part][k], c_end[part][k])]
    if resumed["losses"] != want_losses or bad or a_end["count"] != c_end["count"]:
        raise AssertionError(f"train-stages: the resume: losses {resumed['losses']} vs "
                             f"{want_losses}; {len(bad)} state tensors differ ({bad[:3]})")
    log(f"  stage-3 resume from step {OBJ_RESUME_AT}: losses "
        f"{['%.6f' % x for x in resumed['losses']]} "
        f"equal run a's bit for bit, and the step-{STAGE_STEPS['obj']} state "
        f"({len(a_end['masters'])} masters, moments, count {c_end['count']}) too")
    del a_end, c_end
    for r in (lora, cam, obj, resumed):
        total.update(r["launches"])
        total.update({k: n for v in r["validations"] for k, n in v["launches"].items()})

    # accumulation with remat, in process: launches by step, peak against run a's
    remat = {}
    for policy in ("full", "dots"):
        counts = counters()
        per_step = [{k: fn.launches for k, fn in counts.items()}]

        def on_step(state, metrics, draws):
            per_step.append({k: fn.launches for k, fn in counts.items()})

        cfg = dict(obj_cfg, enable_validation=False, gradient_accumulation_steps=ACCUM,
                   gradient_checkpointing=True, gradient_checkpointing_policy=policy,
                   checkpointing_steps=100, output_dir=os.path.join(runs_dir, f"obj_{policy}"))
        r = train("obj", cfg, max_steps=REMAT_STEPS, on_step=on_step)
        _check_run(f"stage 3 remat {policy}", r, REMAT_STEPS,
                   {k: v * ACCUM for k, v in OBJ_REMAT_PER_MICRO.items()})
        steps = [{k: b[k] - a[k] for k in b} for a, b in zip(per_step, per_step[1:])]
        want = {k: v * ACCUM for k, v in OBJ_REMAT_PER_MICRO.items()}
        if steps != [want] * REMAT_STEPS:
            raise AssertionError(f"train-stages: remat {policy} launches by step {steps}")
        total.update(r["launches"])
        remat[policy] = r
        shutil.rmtree(cfg["output_dir"], ignore_errors=True)
        torch.cuda.empty_cache()

    lines = [_stage_line("stage 1 (lora)", lora), _stage_line("stage 2 (cam)", cam),
             _stage_line("stage 3 (obj)", obj), _stage_line("stage 3 resumed", resumed)]
    lines += [_stage_line(f"stage 3, accumulation {ACCUM}, remat {p}", r, ACCUM)
              for p, r in remat.items()]
    for line in lines:
        log(f"[train-stages] {line}")
    log(f"[train-stages] stage 3 peak: {_gib(obj['peak_gib'])} without remat (batch 1), "
        f"{_gib(remat['full']['peak_gib'])} with 'full', {_gib(remat['dots']['peak_gib'])} "
        f"with 'dots' (accumulation {ACCUM}: one micro-batch alive plus the fp32 gradient sums); "
        f"launches per step: lora {LORA_PER_STEP}, obj {OBJ_PER_STEP}, obj remat per micro-batch "
        f"{OBJ_REMAT_PER_MICRO}; {card}")
    shutil.rmtree(runs_dir, ignore_errors=True)
    return total, results


# ---------------------------------------------------------------------------
# phase tools: the serving export, evaluate, FID and the dataset pre-flight
# ---------------------------------------------------------------------------

EXPORT_TOL = 1e-3  # the loaded artifact's frames against the live eager program's
FEATURE_TOL = 1e-4  # the FID extractor's features, card against CPU (fp32, TF32 off)
FID_REL_TOL = 1e-3
# Kernel names of each forward kernel's launches in a trace; K3's mode B is
# gn_partials + gn_apply, one launch of the wrapper each pair.
TRACE_NAMES = {"flash": ("flash_fwd",), "temporal": ("temporal_fwd",),
               "group_norm": ("gn_cluster", "gn_partials")}
# Denoise steps of the exported serving program: 2, not the serving phase's 4,
# to keep the whole script within its time with the mesh phase (tracing time
# grows with the unrolled steps; the checks do not change).
TOOLS_STEPS = 2
TOOLS_HEAD = (f"[tools] python -m synfmc_tpu_torch.scripts.export_serving --verify at full width "
              f"({FRAMES}x{HEIGHT}x{WIDTH}, bf16, {TOOLS_STEPS} DDIM steps), then the artifact in a "
              f"fresh process against the live program")


def run_child(cmd: list, what: str, timeout: float = 900) -> tuple[str, float]:
    """A child process from the repo root; its stdout and wall seconds;
    raises on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what}: rc {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout, wall


def traced_launches(fn) -> dict:
    """Each forward kernel's launches in one call of ``fn``, counted by
    kernel name in a torch.profiler trace (TRACE_NAMES)."""
    names = [name for name, _ in device_events(fn)]
    out = {k: sum(any(m in n for m in marks) for n in names) for k, marks in TRACE_NAMES.items()}
    applies = sum("gn_apply" in n for n in names)
    if applies != sum("gn_partials" in n for n in names):
        raise AssertionError(f"trace: {applies} gn_apply launches against the gn_partials'")
    return out


TOOLS_CALLS = 3  # timed calls of each program; their median is the call's ms


def _timed_calls(fn, inputs, n: int = TOOLS_CALLS) -> tuple:
    """(the first call's output, the median CUDA-event ms of ``n`` calls, the
    peak GiB over them)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, out = [], None
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn(*inputs)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        out = y if out is None else out
    return out, statistics.median(ms), torch.cuda.max_memory_allocated() / 2**30


def tools_load(path: str) -> int:
    """``--tools-load PATH``, the fresh process of phase tools: load the
    artifact (importing synfmc_tpu_torch.ops registers its ops), run it on
    the export's verify inputs (a first call, TOOLS_CALLS timed ones and a
    traced one), then build the live program with the same seeded weights
    and run it eagerly (a first call, then TOOLS_CALLS timed ones, the
    launch counters from 0 before the first of those); print one JSON line:
    load seconds, ms a call and peak of each, the traced launches and the
    counted ones of one eager call, the frames' max error."""
    t0 = time.perf_counter()
    import synfmc_tpu_torch.ops  # noqa: F401  (registers torch.ops.synfmc)
    from synfmc_tpu_torch.scripts import export_serving as es

    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    shapes = dict(height=HEIGHT, width=WIDTH, frames=FRAMES, num_inference_steps=TOOLS_STEPS)
    inputs = es.sample_inputs(shapes, torch.device("cuda"), seed=7)
    with torch.no_grad():
        t0 = time.perf_counter()
        loaded(*inputs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got, loaded_ms, loaded_peak = _timed_calls(loaded, inputs)
        traced = traced_launches(lambda: loaded(*inputs))
    del loaded
    torch.cuda.empty_cache()
    program, _ = es.build_program(es.parse_args(["--out", path, "--num-inference-steps",
                                                 str(TOOLS_STEPS)]), torch.device("cuda"))
    with torch.no_grad():
        program(*inputs)  # the eager program's first call
        for fn in counters().values():
            fn.launches = 0
        want, eager_ms, eager_peak = _timed_calls(program, inputs)
    eager = {k: counters()[k].launches / TOOLS_CALLS for k in TRACE_NAMES}  # a call's
    print(json.dumps(dict(import_s=import_s, load_s=load_s, first_s=first_s, loaded_ms=loaded_ms,
                          eager_ms=eager_ms, loaded_peak_gib=loaded_peak,
                          eager_peak_gib=eager_peak, traced=traced, eager=eager,
                          max_err=(got.float() - want.float()).abs().max().item(),
                          finite=bool(torch.isfinite(got).all()))), flush=True)
    return 0


def tools_export(card: str) -> Counter:
    """Phase tools: export_serving --verify as a child process, then the
    artifact in a fresh process (``tools_load``): frames within EXPORT_TOL of
    the live program's, the trace's K1-K3 launches equal to the eager run's
    counters and to PER_FORWARD x TOOLS_STEPS + PER_REQUEST + PER_DECODE (one
    decode call of every frame).  Returns the eager run's launches."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="synfmc_export_")
    try:
        path = os.path.join(root, "serve.pt2")
        out, export_wall = run_child([sys.executable, "-m",
                                      "synfmc_tpu_torch.scripts.export_serving", "--out", path,
                                      "--verify", "--num-inference-steps", str(TOOLS_STEPS)],
                                     "export_serving")
        rep = json.loads(out.strip().splitlines()[-1])
        if not rep["verify_ok"]:
            raise AssertionError(f"export_serving --verify: {rep}")
        log(f"  export_serving: process {export_wall:.1f} s, export {rep['export_s']:.1f} s, "
            f"save {rep['save_s']:.1f} s, {rep['bytes']} bytes, {rep['parameters']} parameters, "
            f"{rep['in_avals']} inputs; verify: load {rep['verify_load_s']:.1f} s, loaded vs "
            f"live max err {rep['verify_max_err']:.3e}, a second weight set loaded into both "
            f"{rep['verify_swap_max_err']:.3e} (frames moved by "
            f"{rep['verify_swap_changed']:.3f}); {card}")
        out, load_wall = run_child([sys.executable, os.path.abspath(__file__), "--tools-load",
                                    path], "the artifact in a fresh process")
        r = json.loads(out.strip().splitlines()[-1])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = Counter()
    for _ in range(TOOLS_STEPS):
        want.update(PER_FORWARD)
    want.update(PER_REQUEST)
    want.update(PER_DECODE)
    want = {k: want[k] for k in TRACE_NAMES}
    if not r["finite"] or r["max_err"] >= EXPORT_TOL:
        raise AssertionError(f"tools: loaded frames against the live program: {r}")
    if r["traced"] != r["eager"] or r["eager"] != want:
        raise AssertionError(f"tools: launches traced {r['traced']}, eager {r['eager']}, "
                             f"expected {want}")
    log(f"  fresh process: {load_wall:.1f} s in all, imports {r['import_s']:.1f} s, "
        f"torch.export.load {r['load_s']:.1f} s, first call {r['first_s']:.2f} s; a call "
        f"({TOOLS_STEPS} steps, text and pose encode, decode; median of {TOOLS_CALLS}) loaded "
        f"{r['loaded_ms']:.1f} ms "
        f"({r['loaded_ms'] / TOOLS_STEPS:.1f} a step) against eager {r['eager_ms']:.1f} ms "
        f"({r['eager_ms'] / TOOLS_STEPS:.1f} a step); peak {r['loaded_peak_gib']:.2f} / "
        f"{r['eager_peak_gib']:.2f} GiB; K1-K3 launches traced {r['traced']} = eager "
        f"counters {r['eager']}; frames max err {r['max_err']:.3e}; {card}")
    return Counter({k: int(v) for k, v in r["eager"].items()})


def _extractor(path: str) -> str:
    """A seeded TorchScript feature extractor: three strided convs with ReLU,
    spatial mean -> (N, 8)."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Conv2d(3, 16, 3, stride=2, padding=1)
            self.b = torch.nn.Conv2d(16, 16, 3, stride=2, padding=1)
            self.c = torch.nn.Conv2d(16, 8, 3, stride=2, padding=1)

        def forward(self, x):
            h = torch.relu(self.b(torch.relu(self.a(x))))
            return self.c(h).flatten(2).mean(dim=2)

    torch.manual_seed(0)
    torch.jit.script(Net()).save(path)
    return path


def tools_fid(set_a: list, set_b: list, root: str, card: str) -> None:
    """FID of two sets of GIFs through one seeded TorchScript extractor on the
    card and on the CPU (fp32, TF32 off): features within FEATURE_TOL, the
    distance within FID_REL_TOL relative."""
    from synfmc_tpu_torch.evaluation.fid import (
        extract_features,
        fid_from_features,
        load_torchscript_extractor,
    )
    from synfmc_tpu_torch.utils.video import read_gif

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        path = _extractor(os.path.join(root, "extractor.pt"))
        batches = {k: [(read_gif(g).astype(np.float32) / 255.0).transpose(0, 3, 1, 2)
                       for g in gifs] for k, gifs in (("a", set_a), ("b", set_b))}
        feats, fids = {}, {}
        for dev in ("cuda", "cpu"):
            ext = load_torchscript_extractor(path, None if dev == "cuda" else "cpu")
            feats[dev] = {k: extract_features(v, ext) for k, v in batches.items()}
            fids[dev] = fid_from_features(feats[dev]["a"], feats[dev]["b"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    err = max(float(np.abs(feats["cuda"][k] - feats["cpu"][k]).max()) for k in ("a", "b"))
    rel = abs(fids["cuda"] - fids["cpu"]) / max(abs(fids["cpu"]), 1e-30)
    if not (err < FEATURE_TOL and rel < FID_REL_TOL and np.isfinite(fids["cuda"])):
        raise AssertionError(f"tools: FID card vs CPU: features {err:.3e}, FID {fids}")
    log(f"  FID through a seeded TorchScript extractor ({len(feats['cpu']['a'])} vs "
        f"{len(feats['cpu']['b'])} frames, 8 features): card {fids['cuda']:.6f}, CPU "
        f"{fids['cpu']:.6f} (relative {rel:.2e}), features max err {err:.2e}; {card}")


def tools_evaluate(samples_dir: str, card: str) -> None:
    """``python -m synfmc_tpu_torch.scripts.evaluate`` on a validation
    output: finite RotErr and TransErr for every camera label pair, a finite
    PSNR between cm-0.gif and real-0.gif; each GIF read by decode_gif with
    the frame count and size its blocks give; then the FID of the rendered
    GIFs against the real one, card against CPU."""
    import glob

    from synfmc_tpu_torch.utils.video import decode_gif

    out, wall = run_child([sys.executable, "-m", "synfmc_tpu_torch.scripts.evaluate",
                           "--samples-dir", samples_dir], "evaluate --samples-dir")
    cam = json.loads(out)["camera"]
    pairs = sorted(glob.glob(os.path.join(samples_dir, "cam_label_compute_*.txt")))
    samples = {k: v for k, v in cam.items() if k.startswith("sample_")}
    values = [x for v in samples.values() for key in ("rot_err_deg", "trans_err") for x in v[key]]
    values += [v[k] for v in samples.values() for k in ("rot_err_deg_mean", "trans_err_mean")]
    if (not pairs or len(samples) != len(pairs) or cam["aggregate"]["num_samples"] != len(pairs)
            or not np.isfinite(values).all()):
        raise AssertionError(f"tools: evaluate --samples-dir {samples_dir}: {cam}")
    gifs = {os.path.basename(g): g for g in sorted(glob.glob(os.path.join(samples_dir, "*.gif")))}
    out, wall_v = run_child([sys.executable, "-m", "synfmc_tpu_torch.scripts.evaluate",
                             "--video-a", gifs["cm-0.gif"], "--video-b", gifs["real-0.gif"]],
                            "evaluate --video-a --video-b")
    video = json.loads(out)["video"]
    if not np.isfinite(video["psnr_mean"]):
        raise AssertionError(f"tools: evaluate --video-a cm-0.gif --video-b real-0.gif: {video}")
    shapes = {}
    for name, g in gifs.items():
        data = open(g, "rb").read()
        blocks = gif_blocks(data)
        t0 = time.perf_counter()
        frames = decode_gif(data)
        want = (len(blocks["images"]), blocks["height"], blocks["width"], 3)
        if frames.shape != want:
            raise AssertionError(f"tools: decode_gif({name}) {frames.shape}, its blocks {want}")
        shapes[name] = [list(frames.shape), round(1e3 * (time.perf_counter() - t0), 1)]
    log(f"  evaluate --samples-dir ({wall:.1f} s): {len(pairs)} label pairs, RotErr "
        f"{cam['aggregate']['rot_err_deg_mean']:.4f} deg, TransErr "
        f"{cam['aggregate']['trans_err_mean']:.4f}; --video-a cm-0.gif --video-b real-0.gif "
        f"({wall_v:.1f} s): PSNR {video['psnr_mean']:.3f} dB over "
        f"{video['frames_compared']} frames; decode_gif [shape, ms]: {json.dumps(shapes)}")
    rendered = [g for n, g in gifs.items() if n != "real-0.gif"]
    tools_fid(rendered, [gifs["real-0.gif"]], samples_dir, card)


def tools_validate(config: str, card: str) -> None:
    """``python -m synfmc_tpu_torch.scripts.validate_dataset`` on a fixture's
    config: exit 0 and an OK summary."""
    out, wall = run_child([sys.executable, "-m", "synfmc_tpu_torch.scripts.validate_dataset",
                           "--config", config], "validate_dataset")
    last = out.strip().splitlines()[-1]
    if not last.startswith("OK:"):
        raise AssertionError(f"tools: validate_dataset: {out[-2000:]}")
    log(f"  validate_dataset on the fixture: {last} ({wall:.1f} s)")


def tools_alone(card: str) -> Counter:
    """``--tools``: the export, then evaluate, FID and validate_dataset on
    inputs written here by the package's own writers (a validation-like
    samples directory: three GIFs and two camera label pairs; phase 9's
    fixture dataset) where the full run takes phase 10's validation output
    and phase 9's fixture."""
    import shutil
    import tempfile

    import yaml

    from synfmc_tpu_torch.data.fixture import build_synthetic_dataset
    from synfmc_tpu_torch.utils.video import save_camera_label_txt, save_videos_grid

    launches = tools_export(card)
    root = tempfile.mkdtemp(prefix="synfmc_tools_")
    try:
        d = os.path.join(root, "samples")
        rng = np.random.default_rng(0)
        for name, lo, span in (("real-0.gif", 0.0, 1.0), ("cm-0.gif", 0.0, 0.3),
                               ("omcm-0.gif", 0.05, 0.3)):  # sets far apart: FID not ~0
            save_videos_grid(lo + span * rng.uniform(size=(1, FRAMES, HEIGHT, WIDTH, 3)),
                             os.path.join(d, name))
        for i in range(2):
            for kind in ("compute", "gt"):
                rt = np.concatenate([np.tile(np.eye(3), (FRAMES, 1, 1)),
                                     rng.normal(size=(FRAMES, 3, 1))], -1)
                save_camera_label_txt(os.path.join(d, f"cam_label_{kind}_{i}.txt"), "p", rt)
        tools_evaluate(d, card)
        with open(CAM_YAML) as fh:
            cfg = yaml.safe_load(fh)
        cfg["train_data"]["params"].update(build_synthetic_dataset(os.path.join(root, "data"),
                                                                   **FIXTURE))
        tools_validate(_write_yaml(os.path.join(root, "cam.yaml"), cfg), card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase mesh: the multi-GPU path on the one card
# ---------------------------------------------------------------------------

MESH_HEAD = ("[mesh] one process a rank under python -m torch.distributed.run on the one card: "
             "(a) NCCL at world size 1, (b) data-parallel serving on 2 ranks, (c) frame-parallel "
             "serving on 4 (data 2 x sp 2), (d) training on 2 (data 2, sp 2, then fsdp 2), (e) the "
             "collective stop; (b)-(e) over gloo on cuda:0 (NCCL refuses two ranks on one "
             "device), so these runs show the mesh right, not its scaling; every collective runs "
             "on the CUDA tensors themselves, gloo's included (none is staged through the host)")
MESH_STEPS = 2  # full-width train steps a mesh
MESH_TINY = [c for c in COMPOSE_CASES if c[0] in ("omc", "turbo+dpmpp", "deepcache", "cfgcache")]
MESH_STOP_AT = 2  # rank 1 sends itself SIGTERM after this step
FSDP_STATE_SHARE = 0.55  # a {fsdp: 2} rank's masters and moments against {data: 2}'s
FSDP_LOSS_REL_TOL = 1e-3  # its losses after the first update against one process's


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _torchrun_cmd(n: int, args: list) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
            "--master-port", str(_free_port()), *args]


def torchrun(n: int, args: list, what: str, timeout: float = 600) -> tuple[str, float]:
    """``python -m torch.distributed.run --nproc-per-node n`` args, from the repo root."""
    return run_child(_torchrun_cmd(n, args), what, timeout)


class Background:
    """A child process started now and waited for later (its output in a file)."""

    def __init__(self, cmd: list, log_path: str):
        self.t0, self.log_path = time.perf_counter(), log_path
        self.fh = open(log_path, "w")
        self.proc = subprocess.Popen(cmd, cwd=REPO, stdout=self.fh, stderr=subprocess.STDOUT)

    def wait(self, what: str, timeout: float = 900) -> float:
        """Its wall seconds; raises on a non-zero exit (or kills it at the timeout)."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
            self.fh.close()
        if rc != 0:
            with open(self.log_path) as fh:
                raise AssertionError(f"{what}: rc {rc}\n{fh.read()[-6000:]}")
        return time.perf_counter() - self.t0


def mesh_inputs(pipe, n: int, frames: int = FRAMES, height: int = HEIGHT, width: int = WIDTH):
    """Request (a)'s inputs for ``n`` prompts on the pipeline's device:
    seeded latents, the pan camera's rays, each prompt's seeded objects."""
    gen = torch.Generator().manual_seed(300)
    latents = torch.randn((n, frames, height // 8, width // 8, 4), generator=gen) \
        * pipe.schedule.init_noise_sigma
    rays = plucker(pipe, "pan", frames, height, width).expand(n, -1, -1, -1, -1)
    traj = [object_traj(pipe, 400 + i, frames, height, width) for i in range(n)]
    return latents.to(pipe.device), rays, [torch.cat(t) for t in zip(*traj)]


def mesh_request(pipe, prompts, inputs, kw=None, steps: int = STEPS, decode: bool = True,
                 frames: int = FRAMES, height: int = HEIGHT, width: int = WIDTH) -> dict:
    """One request through AnimationPipeline.__call__ (the pipeline's mesh, if
    any): the latents, the frames, ms per denoise step (CUDA events between
    steps), the launches of the kernels from zero, the collectives' calls and
    bytes sent, and the peak."""
    from synfmc_tpu_torch.parallel import collectives
    from synfmc_tpu_torch.pipelines.animation import decode_latents

    latents, rays, traj = inputs
    events = []

    def on_step(idx, t):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_counters()
    for fn in counters().values():
        fn.launches = 0
    with torch.inference_mode():
        lat = pipe(prompts, video_length=frames, height=height, width=width,
                   num_inference_steps=steps, guidance_scale=GUIDANCE, latents=latents,
                   plucker=rays, traj_features=traj, omcm_min_step=300 if height < HEIGHT else OMCM,
                   decode=False, on_step=on_step, **(kw or {}))
        video = decode_latents(pipe.vae, lat, mesh=pipe.mesh) if decode else None
    torch.cuda.synchronize()
    steps_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"latents": lat.float().cpu(), "video": None if video is None else video.float().cpu(),
            "ms_per_step": statistics.mean(steps_ms) if steps_ms else float("nan"),
            "launches": {k: fn.launches for k, fn in counters().items()},
            "calls": dict(collectives.CALLS), "bytes": dict(collectives.BYTES),
            "host_s": dict(collectives.SECONDS), "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def full_pipe(**kw):
    """The flagship obj-stage pipeline of phase 6 (seeded, every path live)."""
    from synfmc_tpu_torch.pipelines.factory import build_pipeline, randomize_pipeline_

    return randomize_pipeline_(build_pipeline(OBJ_YAML, stage="obj", seed=0,
                                              allow_untrained_cm=True, **kw)[0], 0)


def tiny_pipe(**kw):
    """Phase 4's tiny obj-stage pipeline in fp32 (seeded, every path live)."""
    from synfmc_tpu_torch.pipelines.factory import build_pipeline, randomize_pipeline_

    cfg = tiny_config(mixed_precision=False, path=OBJ_YAML)
    return randomize_pipeline_(build_pipeline(cfg, stage="obj", dtype=torch.float32, seed=0,
                                              allow_untrained_cm=True, **kw)[0], 0)


def tiny_train_steps(mesh_sizes: dict) -> dict:
    """Phase 5's tiny stage-2 model in fp32 on a training mesh (one rank
    without a process group): 2 steps on global batches of 2 samples with
    global draws, each rank on its part.  The first step's loss and averaged
    gradients (under fsdp gathered whole), the trainable tensors after the 2
    AdamW steps (on the CPU)."""
    from synfmc_tpu_torch.data.tokenizer import HashTokenizer
    from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
    from synfmc_tpu_torch.parallel.mesh import gather_shards, shard, training_mesh
    from synfmc_tpu_torch.pipelines.factory import build_models, init_random_
    from synfmc_tpu_torch.training.optim import make_optimizer
    from synfmc_tpu_torch.training.params import partition_params, stage2_cmc_unet_trainable
    from synfmc_tpu_torch.training.steps import (
        average_over,
        apply_grads,
        draw_cam,
        init_train_state,
        make_cam_grads_fn,
    )
    from synfmc_tpu_torch.training.trainers import host_batch, step_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = training_mesh(**mesh_sizes)
    cfg = tiny_config(mixed_precision=False)
    scfg = step_config(cfg, "cam")
    schedule = DiffusionSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    models = build_models(cfg)
    gen = torch.Generator().manual_seed(0)
    for m in models.values():
        init_random_(m, gen)
        m.cuda()
    trainable = {**partition_params(models["unet"], stage2_cmc_unet_trainable, "unet."),
                 **partition_params(models["pose_encoder"], lambda n: True, "pose_encoder.")}
    for name in ("vae", "text"):
        partition_params(models[name], lambda n: False)
    grads_fn = make_cam_grads_fn(models["unet"], models["pose_encoder"], models["vae"],
                                 models["text"], schedule, scfg, sp=mesh.axis("sp"))
    state = init_train_state(trainable, make_optimizer(COMPOSE_LR), mesh=mesh)
    tok, batches, out = HashTokenizer(), synthetic_batches(3, b=2), {}
    part = shard(2, mesh.axis("data"), "samples")
    for step in range(2):
        whole = host_batch(next(batches), tok, "cpu")
        draws = draw_cam(torch.Generator().manual_seed(100 + step), whole, scfg, schedule)
        batch = {k: v if k == "null_ids" else v[part] for k, v in whole.items()}
        grads, metrics = average_over(*grads_fn(state.trainable, {k: v.cuda() for k, v in
                                                                   batch.items()},
                                                draws.part(part, 2).to("cuda")),
                                      mesh.world_group, state.shards)
        if step == 0:
            out["loss"] = float(metrics["loss"])
            wrapped = grads if state.shards is None else state.shards.wrap(grads)
            out["grads"] = {n: g.detach().cpu() for n, g in gather_shards(wrapped).items()}
        apply_grads(state, grads)
    out["params"] = {n: p.detach().cpu() for n, p in state.trainable.items()}
    return out


def _mesh_train(mesh: dict, seed: int, steps: int = MESH_STEPS, stop_at=None,
                trace: bool = False, tiny: bool = False, ckpt_every=None) -> dict:
    """train("cam", configs/cam.yaml) at full width (``tiny``: phase 5's
    tiny widths in fp32) on the mesh ``mesh`` and synthetic batches of
    ``seed``: per step the trainable checksum, the launches and the bytes the
    collectives sent (by op) and their host seconds; the losses, the seconds,
    the peak, this rank's bytes of masters and moments, the checkpoints;
    with ``trace`` the collectives of the last step traced; with
    ``ckpt_every`` checkpoints every that many steps, and rank 0 holds the
    last state.pt's masters, cast to the working type, to the working
    weights (tensor by tensor, and their checksums)."""
    import shutil
    import signal
    import tempfile

    import yaml

    from synfmc_tpu_torch.parallel import collectives
    from synfmc_tpu_torch.parallel.mesh import rank
    from synfmc_tpu_torch.training import checkpoint as ckpt
    from synfmc_tpu_torch.training.trainers import checksum, train

    from torch.profiler import ProfilerActivity, profile

    kernels, per_step, traced, live = counters(), [], {}, {}

    def on_step(state, metrics, draws):
        live["state"] = state
        if trace and state.step == steps - 1:
            torch.cuda.synchronize()
            traced["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            traced["prof"].start()
        elif trace and state.step == steps:
            torch.cuda.synchronize()
            traced["prof"].stop()
        per_step.append({"launches": {k: fn.launches for k, fn in kernels.items()},
                         "checksum": checksum(state.trainable.values()),
                         "bytes": sum(collectives.BYTES.values()),
                         "bytes_by_op": dict(collectives.BYTES),
                         "host_s": sum(collectives.SECONDS.values())})
        for fn in kernels.values():
            fn.launches = 0
        collectives.reset_counters()
        if stop_at is not None and (rank(), state.step) == (1, stop_at):
            os.kill(os.getpid(), signal.SIGTERM)

    if tiny:
        cfg = dict(tiny_config(mixed_precision=False))
    else:
        with open(CAM_YAML) as fh:
            cfg = yaml.safe_load(fh)
    if mesh:
        cfg["mesh"] = mesh
    if ckpt_every:
        cfg["checkpointing_steps"] = ckpt_every
    cfg["output_dir"] = tempfile.mkdtemp(prefix="synfmc_mesh_train_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_counters()
    for fn in kernels.values():
        fn.launches = 0
    state_check = None
    try:
        out = train("cam", cfg, synthetic_batches(seed), steps, seed=0, on_step=on_step)
        peak = torch.cuda.max_memory_allocated()
        if ckpt_every and rank() == 0:
            saved = ckpt.restore_native(os.path.join(out["run_dir"], "checkpoints",
                                                     f"step-{out['steps']}"))
            working = live["state"].trainable
            cast = {n: m.cuda().to(working[n].dtype) for n, m in saved["masters"].items()}
            state_check = {
                "equal": sum(torch.equal(cast[n], p) for n, p in working.items()),
                "tensors": len(working),
                "file_checksum": checksum(t.contiguous() for t in cast.values()),
                "working_checksum": checksum(p.contiguous() for p in working.values())}
            del cast, saved
    finally:
        shutil.rmtree(cfg["output_dir"], ignore_errors=True)
    return {"losses": out["losses"], "steps": out["steps"], "preempted": out.get("preempted"),
            "per_step": per_step, "step_s": out["step_s"],
            "peak_gib": peak / 2**30, "state_bytes": out["state_bytes"], "checkpoints": out["checkpoints"],
            "assembled": out["assembled"], "state_check": state_check,
            "trace": _collective_ms(traced["prof"]) if trace else None}


def _collective_trace(fn) -> dict:
    """``_collective_ms`` over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _collective_ms(prof)


def _collective_ms(prof) -> dict:
    """Calls and device ms (the kernels and copies launched inside) of the
    collectives' ``synfmc::*`` ranges in a torch.profiler trace."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith("synfmc::"):
            out[e.key[len("synfmc::"):]] = {
                "calls": e.count, "device_ms": getattr(e, "device_time_total", 0.0) / 1e3}
    return out


def mesh_child(group: str, root: str) -> int:
    """A rank of ``python -m torch.distributed.run ... chip_smoke.py
    --mesh-child GROUP ROOT``: runs the group's cases and writes this rank's
    results to ROOT/GROUP.rankN.pt."""
    import torch.distributed as dist

    from synfmc_tpu_torch.parallel.mesh import init_distributed, rank, world_size

    if group == "nccl":
        init_distributed()  # NCCL on cuda:LOCAL_RANK
    else:
        init_distributed(backend="gloo", device="cuda:0")  # ranks share the one card
    res = {"device": torch.cuda.get_device_name(0), "world": world_size()}
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent runs after phase 3
    torch.backends.cudnn.allow_tf32 = False
    if group == "nccl":
        res["train"] = _mesh_train({"data": 1}, seed=0)  # phase 7's batches
    elif group == "gloo2":
        pipe = full_pipe(data_parallel=2, batch=2)
        prompts = [REQUESTS[0][1], REQUESTS[1][1]]
        res["dp"] = mesh_request(pipe, prompts, mesh_inputs(pipe, 2))
        res["dp"]["video"] = res["dp"]["video"][rank()]  # this rank's prompt
        del pipe
        torch.cuda.empty_cache()
        res["train_data"] = _mesh_train({"data": 2}, seed=10 + rank())
        res["train_sp"] = _mesh_train({"sp": 2}, seed=10, trace=True)
        torch.cuda.empty_cache()
        # phase 7's batches on both ranks: the fsdp ranks of a data line see the
        # same samples; one checkpoint, at the last step, gathered from the shards
        res["train_fsdp"] = _mesh_train({"fsdp": 2}, seed=0, trace=True, ckpt_every=MESH_STEPS)
        torch.cuda.empty_cache()
        res["tiny_data"] = tiny_train_steps({"data": 2})
        res["tiny_sp"] = tiny_train_steps({"sp": 2})
        res["tiny_fsdp"] = tiny_train_steps({"fsdp": 2})
        res["stop"] = _mesh_train({"data": 2}, seed=10 + rank(), steps=6, stop_at=MESH_STOP_AT,
                                  tiny=True)
    elif group == "gloo4":
        pipe = full_pipe(frame_parallel=2, batch=1)
        res["fp"] = mesh_request(pipe, [REQUESTS[0][1]], mesh_inputs(pipe, 1))
        res["trace_fp"] = _collective_trace(lambda: mesh_request(
            pipe, [REQUESTS[0][1]], mesh_inputs(pipe, 1), steps=1, decode=False))
        if rank():
            res["fp"]["video"] = None
        del pipe
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        pipe = tiny_pipe(frame_parallel=2, batch=1)
        res["tiny"] = {}
        for label, frames, height, width, objs, kw in MESH_TINY:
            out = mesh_request(pipe, ["a knight marches across a field"],
                               mesh_inputs(pipe, 1, frames, height, width), kw, steps=3,
                               decode=False, frames=frames, height=height, width=width)
            res["tiny"][label] = out["latents"]
        del pipe
        res["tiny_fsdp_sp"] = tiny_train_steps({"fsdp": 2, "sp": 2})
    else:
        raise ValueError(f"unknown mesh group {group!r}")
    torch.save(res, os.path.join(root, f"{group}.rank{rank()}.pt"))
    dist.destroy_process_group()
    return 0


def _ranks(root: str, group: str, n: int) -> list:
    return [torch.load(os.path.join(root, f"{group}.rank{r}.pt"), weights_only=False)
            for r in range(n)]


def _per_step_exact(name: str, per_step: list, want: dict) -> None:
    for i, s in enumerate(per_step):
        if s["launches"] != want:
            raise AssertionError(f"{name} step {i + 1}: launches {s['launches']} != {want}")


def _mesh_generate(root: str, card: str) -> None:
    """(a), serving: the command line under torchrun at world size 1 (NCCL)
    and in this process, request (a)'s shape from a seeded OMC bundle, a pan
    camera file and seeded objects: frames equal bit for bit."""
    from synfmc_tpu_torch.scripts import generate

    pipe = full_pipe()
    omcm = os.path.join(root, "omcm.ckpt")
    torch.save({"omcm_state_dict": {k: v.cpu() for k, v in pipe.adapter.state_dict().items()}},
               omcm)
    del pipe
    torch.cuda.empty_cache()
    cam_txt = os.path.join(root, "camera.txt")
    with open(cam_txt, "w") as fh:
        fh.write(camera_label_text("pan"))
    info, masks = objects(400, FRAMES, HEIGHT, WIDTH)
    obj_npz = os.path.join(root, "objects.npz")
    np.savez(obj_npz, obj_info=info[0], obj_masks=masks[0])
    args = ["--config", OBJ_YAML, "--prompt", REQUESTS[0][1], "--omcm-ckpt", omcm,
            "--allow-untrained-cm", "--camera-txt", cam_txt, "--obj-traj-npz", obj_npz,
            "--num-inference-steps", str(STEPS), "--video-length", str(FRAMES),
            "--guidance-scale", str(GUIDANCE), "--seed", "31"]
    out, wall = torchrun(1, ["-m", "synfmc_tpu_torch.scripts.generate", *args, "--data-parallel",
                             "1", "--out", os.path.join(root, "a.gif"), "--save-frames",
                             os.path.join(root, "a.npz")], "generate --data-parallel 1")
    line = next(x for x in out.splitlines() if x.startswith("# generate:"))
    generate.main([*args, "--out", os.path.join(root, "b.gif"),
                   "--save-frames", os.path.join(root, "b.npz")])
    torch.cuda.empty_cache()
    a, b = np.load(os.path.join(root, "a.npz")), np.load(os.path.join(root, "b.npz"))
    if not np.array_equal(a["video"], b["video"]):
        raise AssertionError(f"(a) generate: torchrun frames differ from in-process by "
                             f"{np.abs(a['video'] - b['video']).max()}")
    log(f"  (a) generate --data-parallel 1 under torchrun (NCCL, world 1): {wall:.1f} s; frames "
        f"{a['video'].shape} equal the in-process run's bit for bit; {line}; {card}")


def _check_tiny(name: str, ranks: list, ref: dict) -> None:
    """Phase 5's tiny step on a mesh (``ranks``' tiny_train_steps) against one
    process (``ref``) with phase 5's limits; every rank's parameters equal."""
    got = ranks[0]
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_rel = max(kernel_error(got["grads"][n], g)[1] for n, g in ref["grads"].items())
    param_err = max((got["params"][n] - p).abs().max().item() for n, p in ref["params"].items())
    same = all(torch.equal(x["params"][n], p) for x in ranks[1:] for n, p in got["params"].items())
    log(f"  {name} vs one process on the concatenated batch: loss rel {loss_rel:.2e} (1e-5), "
        f"gradients {grad_rel:.2e} (1e-3), parameters after 2 AdamW steps {param_err:.2e} "
        f"(2 lr), replicas equal {same}")
    if not (loss_rel < 1e-5 and grad_rel < 1e-3 and param_err < 2 * COMPOSE_LR and same):
        raise AssertionError(f"{name}: loss {loss_rel}, grads {grad_rel}, params {param_err}, "
                             f"replicas equal {same}")


def _check_fsdp(r2: list, ref_losses: list, launches: Counter, card: str) -> None:
    """(d) on {fsdp: 2}: the first loss equal to the single process's bit
    for bit and the later ones within FSDP_LOSS_REL_TOL, the replicas'
    working weights equal bit for bit after every step, launches exact, a
    rank's masters and moments at most FSDP_STATE_SHARE of {data: 2}'s, and
    the gathered state.pt, cast to bf16, equal to the working weights."""
    fs = [x["train_fsdp"] for x in r2]
    sums = [[st["checksum"] for st in x["per_step"]] for x in fs]
    if sums[0] != sums[1]:
        raise AssertionError(f"(d) train_fsdp: replica checksums differ: {sums}")
    for r, x in enumerate(fs):
        _per_step_exact(f"(d) train_fsdp rank {r}", x["per_step"], TRAIN_PER_STEP)
        for st in x["per_step"]:
            launches.update(st["launches"])
        rel = [abs(a - b) / abs(b) for a, b in zip(x["losses"][1:], ref_losses[1:])]
        share = x["state_bytes"] / r2[r]["train_data"]["state_bytes"]
        log(f"  (d) train_fsdp rank {r}: losses {x['losses']} (one process {ref_losses}: the "
            f"first bit for bit, then relative {['%.2e' % v for v in rel]}, limit "
            f"{FSDP_LOSS_REL_TOL}), step {['%.1f' % (t * 1e3) for t in x['step_s']]} ms, peak "
            f"{x['peak_gib']:.2f} GiB (data=2: {r2[r]['train_data']['peak_gib']:.2f}), fp32 "
            f"masters and moments {x['state_bytes']} bytes = {share:.4f} of data=2's "
            f"{r2[r]['train_data']['state_bytes']} (limit {FSDP_STATE_SHARE}), bytes sent a step "
            f"by op {[st['bytes_by_op'] for st in x['per_step']]}, host s in the collectives "
            f"a step {['%.3f' % st['host_s'] for st in x['per_step']]}, checksums {sums[r]} "
            f"(equal on both ranks), checkpoints assembled at steps {x['assembled']}; {card}")
        if x["losses"][0] != ref_losses[0] or not all(v < FSDP_LOSS_REL_TOL for v in rel):
            raise AssertionError(f"(d) train_fsdp rank {r}: losses {x['losses']} vs one "
                                 f"process {ref_losses}")
        if not share <= FSDP_STATE_SHARE:
            raise AssertionError(f"(d) train_fsdp rank {r}: masters and moments {share:.4f} of "
                                 f"data=2's")
    chk = fs[0]["state_check"]
    (c,) = fs[0]["checkpoints"]
    log(f"  (d) train_fsdp checkpoint at step {c['step']}: {c['path']}, {c['copy_s']:.3f} s in "
        f"the loop of which the gather {c['gather_s']:.3f} s, host copy "
        f"{c['writer_copy_s']:.3f} s and write {c['write_s']:.2f} s in the writer, "
        f"{c['bytes'] / 2**30:.3f} GiB; state.pt's masters as bf16 equal the working weights "
        f"in {chk['equal']} of {chk['tensors']} tensors, checksums {chk['file_checksum']} / "
        f"{chk['working_checksum']}; {card}")
    if chk["equal"] != chk["tensors"] or chk["file_checksum"] != chk["working_checksum"]:
        raise AssertionError(f"(d) train_fsdp: the gathered state.pt differs from the working "
                             f"weights: {chk}")
    log(f"  (d) fsdp=2 train step {MESH_STEPS}, collectives traced (rank 0): "
        f"{json.dumps(fs[0]['trace'])}; {card}")


def mesh_phase(card: str, ref_losses=None) -> Counter:
    """The mesh phase (MESH_HEAD); returns the ranks' launches on the mesh path.
    ``ref_losses``: phase 7's first MESH_STEPS losses (the same run in this
    process), else (a) takes its own."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # as the children run (mesh_child)
    torch.backends.cudnn.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="synfmc_mesh_")
    launches = Counter()
    me = os.path.abspath(__file__)
    children = []
    try:
        # (a) NCCL at world size 1 and (c)'s 4 ranks run beside each other and the
        # generate runs, to keep the script within its time: (c)'s times are
        # taken with (a)'s processes on the card too; (b), (d), (e) run alone
        gloo4 = Background(_torchrun_cmd(4, [me, "--mesh-child", "gloo4", root]),
                           os.path.join(root, "gloo4.log"))
        nccl = Background(_torchrun_cmd(1, [me, "--mesh-child", "nccl", root]),
                          os.path.join(root, "nccl.log"))
        children += [gloo4, nccl]
        _mesh_generate(root, card)
        wall = nccl.wait("mesh child nccl")
        (a,) = _ranks(root, "nccl", 1)
        if ref_losses is None:
            ref_losses = _mesh_train({}, seed=0)["losses"]
            torch.cuda.empty_cache()
        got = a["train"]
        if got["losses"] != list(ref_losses):
            raise AssertionError(f"(a) train: NCCL world-1 losses {got['losses']} vs in-process "
                                 f"{list(ref_losses)}")
        _per_step_exact("(a) train", got["per_step"], TRAIN_PER_STEP)
        for s in got["per_step"]:
            launches.update(s["launches"])
        log(f"  (a) train('cam') mesh data=1 under NCCL: {wall:.1f} s with the generate runs; losses "
            f"{got['losses']} equal the in-process run's bit for bit, launches per step exact")
        wall4 = gloo4.wait("mesh child gloo4")

        # (b), (d), (e): 2 ranks over gloo on cuda:0
        _, wall = torchrun(2, [me, "--mesh-child", "gloo2", root], "mesh child gloo2", 900)
        r2 = _ranks(root, "gloo2", 2)
        log(f"  2-rank child: {wall:.1f} s")
        ref_pipe = pipe = full_pipe()  # the single-process runs of (b) and (c)
        prompts = [REQUESTS[0][1], REQUESTS[1][1]]
        latents, rays, traj = mesh_inputs(pipe, 2)
        for r in range(2):
            one = mesh_request(pipe, [prompts[r]], (latents[r:r + 1], rays[r:r + 1],
                                                    [t[r:r + 1] for t in traj]))
            dp = r2[r]["dp"]
            if not torch.equal(dp["video"], one["video"][0]):
                raise AssertionError(f"(b) rank {r}: frames differ from the batch-1 run by "
                                     f"{(dp['video'] - one['video'][0]).abs().max().item()}")
            want = expected_launches({}, "pan", FRAMES)
            if dp["launches"] != want:
                raise AssertionError(f"(b) rank {r}: launches {dp['launches']} != {want}")
            launches.update(dp["launches"])
            log(f"  (b) data-parallel rank {r}: frames equal its prompt's batch-1 run bit for "
                f"bit; {dp['ms_per_step']:.2f} ms/step (batch 1 alone {one['ms_per_step']:.2f}), "
                f"peak {dp['peak_gib']:.2f} GiB, launches {dp['launches']}, collectives "
                f"{dp['calls']}, bytes sent {dp['bytes']}, host s in them {dp['host_s']}")
        for key in ("train_data", "train_sp"):
            ranks = [x[key] for x in r2]
            if [s["checksum"] for s in ranks[0]["per_step"]] != \
                    [s["checksum"] for s in ranks[1]["per_step"]]:
                raise AssertionError(f"(d) {key}: replica checksums differ")
            for r, x in enumerate(ranks):
                _per_step_exact(f"(d) {key} rank {r}", x["per_step"], TRAIN_PER_STEP)
                for s in x["per_step"]:
                    launches.update(s["launches"])
                log(f"  (d) {key} rank {r}: losses {['%.5f' % v for v in x['losses']]}, step "
                    f"{['%.1f' % (t * 1e3) for t in x['step_s']]} ms, peak "
                    f"{x['peak_gib']:.2f} GiB, bytes sent a step "
                    f"{[s['bytes'] for s in x['per_step']]}, host s in the collectives a step "
                    f"{['%.3f' % s['host_s'] for s in x['per_step']]}, checksums "
                    f"{[s['checksum'] for s in x['per_step']]} (equal on both ranks)")
        log(f"  (d) sp=2 train step {MESH_STEPS}, collectives traced (rank 0): "
            f"{json.dumps(r2[0]['train_sp']['trace'])}")
        _check_fsdp(r2, list(ref_losses), launches, card)
        ref = tiny_train_steps({})
        for key in ("tiny_data", "tiny_sp", "tiny_fsdp"):
            _check_tiny(f"(d) {key}", [x[key] for x in r2], ref)
        stops = [x["stop"] for x in r2]
        if [s["steps"] for s in stops] != [MESH_STOP_AT] * 2 or not all(s["preempted"]
                                                                       for s in stops):
            raise AssertionError(f"(e) stop: steps {[s['steps'] for s in stops]}, preempted "
                                 f"{[s['preempted'] for s in stops]}")
        log(f"  (e) SIGTERM to rank 1 after step {MESH_STOP_AT} (tiny width, data=2): both ranks "
            f"stopped at step {MESH_STOP_AT}, preempted")

        # (c): 4 ranks, data 2 x sp 2 (run beside (a))
        r4 = _ranks(root, "gloo4", 4)
        _check_tiny("(c) tiny_fsdp_sp on fsdp 2 x sp 2", [x["tiny_fsdp_sp"] for x in r4], ref)
        log(f"  4-rank child (beside (a)'s runs): {wall4:.1f} s")
        want = expected_launches({}, "pan", FRAMES // 2)
        for r, x in enumerate(r4):
            fp = x["fp"]
            if fp["launches"] != want:
                raise AssertionError(f"(c) rank {r}: launches {fp['launches']} != {want}")
            launches.update(fp["launches"])
            log(f"  (c) frame-parallel rank {r}: {fp['ms_per_step']:.2f} ms/step, peak "
                f"{fp['peak_gib']:.2f} GiB, launches {fp['launches']}, collectives {fp['calls']}, "
                f"bytes sent {fp['bytes']}, host s in them {fp['host_s']} over {STEPS} steps "
                f"and the decode")
        log(f"  (c) one frame-parallel step, collectives traced (rank 0): "
            f"{json.dumps(r4[0]['trace_fp'])}")
        pipe = ref_pipe
        one = mesh_request(pipe, [REQUESTS[0][1]], mesh_inputs(pipe, 1))
        fp = r4[0]["fp"]
        if not (torch.isfinite(fp["latents"]).all() and fp["latents"].shape == one["latents"].shape):
            raise AssertionError("(c) frame-parallel latents not finite or misshapen")
        err = (fp["latents"] - one["latents"]).abs().max().item()
        img = (fp["video"] - one["video"]).abs().max().item()
        log(f"  (c) request (a) at full width (bf16): latents max abs diff {err:.4e} from the "
            f"single-process run (max |latent| {one['latents'].abs().max().item():.3f}), frames "
            f"{img:.4e}; single process {one['ms_per_step']:.2f} ms/step, peak "
            f"{one['peak_gib']:.2f} GiB; {card}")
        del pipe, ref_pipe
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        pipe = tiny_pipe()
        for label, frames, height, width, objs, kw in MESH_TINY:
            ref = mesh_request(pipe, ["a knight marches across a field"],
                               mesh_inputs(pipe, 1, frames, height, width), kw, steps=3,
                               decode=False, frames=frames, height=height, width=width)
            got = [x["tiny"][label] for x in r4]
            err = max((g - ref["latents"]).abs().max().item() for g in got)
            log(f"  (c) tiny fp32 {label}: {frames} frames {height}x{width}, all 4 ranks' latents "
                f"within {err:.3e} of the single-process run (limit {LATENT_TOL})")
            if not err < LATENT_TOL:
                raise AssertionError(f"(c) tiny {label}: latents differ by {err}")
        del pipe
        torch.cuda.empty_cache()
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[mesh] {time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


_FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K5 flash_bwd", ("flash_bwd",)),
    ("K2 temporal_fwd", ("temporal_fwd",)),
    ("K8 temporal_bwd", ("temporal_bwd",)),
    ("K3 group_norm", ("gn_cluster", "gn_partials", "gn_apply")),
    ("conv (cuDNN)", ("fprop", "conv", "dgrad", "wgrad", "cudnn")),
    ("gemm (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copy/cat", ("copy", "cat", "permute", "transpose", "memcpy", "memset")),
    ("softmax/reduce", ("softmax", "reduce")),
    ("optimizer (AdamW)", ("adam", "multi_tensor_apply")),
)


def device_spans(prof, per: int):
    """(device-busy ms, span ms, kernels, device ms by family), each per
    ``per`` steps, from a trace's CUDA events: busy is the union of kernel
    intervals, span the first start to the last end.  Logs the copy/cat
    family's ten largest kernels by name (launches and ms, per step)."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, spans[0][0]
    for start, end, _ in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    families, copies, copy_launches = Counter(), Counter(), Counter()
    for start, end, n in spans:
        n = n.lower()
        fam = next((f for f, keys in _FAMILIES if any(k in n for k in keys)),
                   "other elementwise")
        families[fam] += (end - start) / 1e3 / per
        if fam == "copy/cat":
            short = re.sub(r"void |at::native::|\(anonymous namespace\)::", "", n)[:120]
            copies[short] += (end - start) / 1e3 / per
            copy_launches[short] += 1 / per
    log("[profile] copy/cat by kernel (launches, ms per step): " + json.dumps(
        {k: [copy_launches[k], round(v, 3)] for k, v in copies.most_common(10)}))
    return (busy_us / 1e3 / per, (spans[-1][1] - spans[0][0]) / 1e3 / per, len(spans) / per,
            {k: round(v, 3) for k, v in families.most_common()})


def profile_loop(pipe, request) -> dict:
    """One request's denoise loop (STEPS steps) in its mode, once untraced and
    once under torch.profiler with CUDA activity only: device time per step
    by kernel family, and the device's idle share over the traced loop (1 -
    the union of device intervals over the span from the first one's start
    to the last one's end).  The tracer adds host time per launch, so the
    traced idle share is an upper bound; the untraced loop's step time is
    beside it."""
    from torch.profiler import ProfilerActivity, profile

    from synfmc_tpu_torch.pipelines.animation import denoise_loop

    label, prompt, cam, objs, kw = request
    kw = {k: v for k, v in kw.items() if k != "decode_chunk"}
    overlap = kw.get("multidiff_overlaps", 0)
    frames = kw.get("multidiff_total_steps", 1) * (FRAMES - overlap) + overlap
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(7)
    context = pipe.encode_prompt(prompt)
    pose = pipe.encode_pose(plucker(pipe, cam, frames)) if cam else None
    traj = object_traj(pipe, seed=7) if objs else None
    lat = torch.randn(1, frames, HEIGHT // 8, WIDTH // 8, 4, generator=gen, device=dev)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        denoise_loop(pipe.unet, pipe.schedule, lat, context, pose_features=pose,
                     traj_features=traj, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                     omcm_min_step=OMCM, window_length=FRAMES, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    run()
    untraced_ms = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_ms = run()
    busy_ms, span_ms, n_kernels, families = device_spans(prof, STEPS)
    out = {"request": label, "steps": STEPS, "untraced_ms_per_step": untraced_ms,
           "traced_ms_per_step": traced_ms, "device_busy_ms_per_step": busy_ms,
           "kernels_per_step": n_kernels, "idle_share_traced": 1 - busy_ms / span_ms,
           "idle_share_estimate_untraced": 1 - busy_ms / untraced_ms,
           "families_ms_per_step": families}
    log(f"[profile] denoise loop of request {label}: {json.dumps(out)}")
    if not kw:
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                      max_name_column_width=60))
    return out


KERNELS = [  # (name, result kind, source, TPU kernel replaced, stand-in key or None)
    ("K1 flash_fwd", "flash", "flash_fwd.cu", "synfmc_tpu/ops/flash_attention.py:117", None),
    ("K2 temporal_fwd", "temporal", "temporal_fwd.cu", "synfmc_tpu/ops/temporal_attention.py:75",
     None),
    ("K3 group_norm", "group_norm", "group_norm.cu", "synfmc_tpu/ops/pallas_groupnorm.py:58", None),
    ("K4 flash_fwd_padded", "flash", "flash_fwd.cu", "synfmc_tpu/ops/flash_attention.py:69",
     K47_KEY),
    ("K5 flash_bwd", "flash_bwd", "flash_bwd.cu", "synfmc_tpu/ops/flash_attention.py:302", None),
    ("K6 flash_bwd_qblocked", "flash_bwd", "flash_bwd.cu",
     "synfmc_tpu/ops/flash_attention.py:254", K6_KEY),
    ("K7 flash_bwd_padded", "flash_bwd", "flash_bwd.cu", "synfmc_tpu/ops/flash_attention.py:165",
     K47_KEY),
    ("K8 temporal_bwd", "temporal_bwd", "temporal_bwd.cu",
     "synfmc_tpu/ops/temporal_attention.py:87", None),
]


def summarise(results, launches):
    """One JSON entry per TPU kernel: a main-path kernel at its hottest shape
    (count x time), a stand-in at its own shape; launches from the main-path
    runs (serving and training; 0 for the stand-ins, which are off the path)."""
    summary = []
    for name, kind, src, replaces, standin in KERNELS:
        rows = [r for r in results[kind] if (r["key"] == standin) == (standin is not None)
                and (standin is not None or r["key"][0] not in ("k4/k7", "k6"))]
        hot = max((r for r in rows if r["key"][0] not in COALESCED),
                  key=lambda r: r["per_forward"] * r["ms"])
        summary.append({
            "name": name, "route": "cuda", "source": f"synfmc_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": 0 if standin else launches[kind],
            "max_abs_err": max(r["err"] for r in rows), "max_rel_err": max(r["rel"] for r in rows),
            "ms": hot["ms"], "plain_ms": hot["plain_ms"], "bound_ms": hot["bound_ms"],
            # exponentials are operations of the special-function units
            "bound_by": "bytes" if hot["bound_by"] == "bytes" else "operations",
            "bound_term": hot["bound_by"], "library_ms": hot["library_ms"],
            "device_ms": hot["device_ms"], "library_device_ms": hot["library_device_ms"],
            "shape": list(hot["key"][1:]), "shapes_checked": len(rows),
        })
    return summary


def passes_only(root: str) -> int:
    """``--passes [ROOT]``: K1's device time by kernel at its three keys (level
    0 serving and train, level 1 serving) beside SDPA's forward kernels, and
    the flash backward's per-pass device times at the train step's two
    spatial keys, with the port package of the tree at ROOT (default: this
    one), for comparing two trees in one call."""
    sys.path.insert(0, os.path.abspath(root))
    from synfmc_tpu_torch.ops import _cuda

    log(f"[passes] {_cuda.__file__}; {' / '.join(smi('name,power.limit'))}")
    _cuda.build_all(("flash_fwd", "flash_bwd"))
    for b, s, c, heads in ((32, 1536, 320, 8), (16, 1536, 320, 8), (32, 384, 640, 8)):
        log(f"[passes] {json.dumps(flash_fwd_kernels(b, s, c, heads))}")
    for b, s, c, heads in ((16, 1536, 320, 8), (16, 384, 640, 8)):
        log(f"[passes] {json.dumps(flash_bwd_passes(b, s, c, heads))}")
        log(f"[passes] {json.dumps(library_bwd_kernels(b, s, c, heads))}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--passes"]:
        return passes_only(args[1] if len(args) > 1 else REPO)
    sys.path.insert(0, REPO)
    if args[:1] == ["--tools-load"]:
        return tools_load(args[1])
    if args[:1] == ["--mesh-child"]:
        return mesh_child(args[1], args[2])
    from synfmc_tpu_torch.data import image
    from synfmc_tpu_torch.ops import _cuda
    from synfmc_tpu_torch.pipelines.factory import build_pipeline, randomize_pipeline_

    profile = "--profile" in args
    t_script = time.perf_counter()

    def header(msg: str) -> None:
        """A phase's first line, with the script's seconds so far."""
        log(f"{msg} (at {time.perf_counter() - t_script:.0f} s)")

    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    form, rates = rates_for(name, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"[device] {name} (rates of the H100 {form}: {rates}); torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(card[0] if card else "nvidia-smi: no output")

    t0 = time.perf_counter()
    logs = _cuda.build_all()
    for src, text in logs.items():
        res = ptxas_resources(text)
        regs = sorted(r for r, _, _ in res.values()) or [0]
        spills = [f"{k} {st}/{ld} B" for k, (_, st, ld) in res.items() if st or ld]
        log(f"[build] {src}: {len(res)} kernels, {regs[0]}-{regs[-1]} registers; "
            f"spill stores/loads: {', '.join(spills) or 'none'}")
    for src in _cuda.SOURCES:
        _cuda.load(src)
    image.library()  # the data loader's PNG unfilter and resampler (host C++)
    log(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s; "
        f"{image.library_path().name}")
    if "--train-files" in args or "--train-stages" in args:
        import shutil
        import tempfile

        root = tempfile.mkdtemp(prefix="synfmc_train_files_")
        try:
            log(TRAIN_FILES_HEAD if "--train-files" in args else TRAIN_STAGES_HEAD)
            w = prepare_train_files(root)
            if "--train-files" in args:
                train_files(card[0] if card else "", root, w)
            else:
                train_stages(card[0] if card else "", root, w, rates, set(), set())
        finally:
            shutil.rmtree(root, ignore_errors=True)
        return 0
    if "--tools" in args:
        log(TOOLS_HEAD)
        tools_alone(card[0] if card else "")
        return 0
    if "--mesh" in args:
        log(MESH_HEAD)
        launches = mesh_phase(card[0] if card else "")
        log(f"[mesh] launches on the mesh path, all ranks: {dict(launches)}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    t0 = time.perf_counter()
    # seeded weights with every conditioning path live (no checkpoint files yet); the
    # pipeline alone is kept (the info dict holds the modules too)
    pipe = randomize_pipeline_(build_pipeline(OBJ_YAML, stage="obj", seed=0,
                                              allow_untrained_cm=True)[0], 0)
    log(f"[main] flagship obj-stage pipeline built in {time.perf_counter() - t0:.1f} s, "
        f"UNet {sum(p.numel() for p in pipe.unet.parameters()) / 1e6:.0f} M params, "
        f"ObjectAdapter {sum(p.numel() for p in pipe.adapter.parameters()) / 1e6:.0f} M, "
        f"{pipe.unet.dtype}")

    gn_silu_range()
    log("[kernels] shapes recorded from one full-width forward on the pair, one at batch 1, a "
        "shallow forward, the pose encoder, the adapter, a frame decode and a "
        f"{DECODE_CHUNK}-frame decode; and K4's stand-in")
    seen = record_shapes(pipe)
    seen["flash"][K47_KEY] = 0
    traced = set()
    results = check_kernels(seen, rates, traced)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    header("[compose] tiny obj stage, 3 steps, fp32: GPU vs CPU, one OMC request and each mode")
    compose()

    header(f"[train-compose] tiny width, {FRAMES} frames at {HEIGHT}x{WIDTH}, 2 stage-2 steps, "
           f"fp32: GPU vs CPU")
    train_compose()

    header(f"[main] {len(REQUESTS)} requests: {FRAMES}-frame windows {HEIGHT}x{WIDTH}, {STEPS} "
        f"steps, guidance {GUIDANCE}, OMC gate {OMCM}")
    launches, per_mode = serve(pipe, card[0] if card else "")
    log(f"[main] per mode: {json.dumps({k: {m: v[m] for m in ('ms_per_step', 'clip_s', 'launches_per_step', 'peak_gib')} for k, v in per_mode.items()})}; "
        f"{card[0] if card else ''}")
    op_route_cost(seen, per_mode[REQUESTS[0][0]]["ms_per_step"], card[0] if card else "")
    if profile:
        for request in REQUESTS:
            profile_loop(pipe, request)
    del pipe
    torch.cuda.empty_cache()

    header(f"[train] train('cam', configs/cam.yaml): batch 1, {FRAMES} frames {HEIGHT}x{WIDTH}, "
        f"bf16 with fp32 masters, {TRAIN_STEPS} AdamW steps")
    tr = train_main(profile)
    launches.update(tr["launches"])
    torch.cuda.empty_cache()

    header("[backward] kernels at the train step's recorded shapes, K6/K7 stand-ins, fp32")
    fwd_train = {k: Counter({key: n for key, n in tr["seen"][k].items() if key not in seen[k]})
                 for k in ("flash", "temporal", "group_norm")}
    for kind, rows in check_kernels(fwd_train, rates, traced, fp32=False).items():
        results[kind] += rows
    bwd_seen = {k: Counter(tr["seen"][k]) for k in ("flash_bwd", "temporal_bwd")}
    bwd_seen["flash_bwd"][K6_KEY] = bwd_seen["flash_bwd"][K47_KEY] = 0
    results.update(check_bwd(bwd_seen, rates))
    time_gn_bwd(tr["seen"]["group_norm_bwd"], rates)
    passes = [flash_bwd_passes(*key[1:5])
              for key in sorted(tr["seen"]["flash_bwd"], key=lambda k: -k[2])]
    log(f"[backward] flash_bwd passes by device time (level 0 first): {json.dumps(passes)}")

    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="synfmc_train_files_")
    try:
        header(TRAIN_FILES_HEAD)
        w = prepare_train_files(root)
        launches.update(train_files(card[0] if card else "", root, w))
        tools_validate(w["configs"]["a"], card[0] if card else "")
        torch.cuda.empty_cache()
        header(TRAIN_STAGES_HEAD)
        checked = {(kind, r["key"][1:]) for kind, rows in results.items() for r in rows}
        stage_launches, stage_results = train_stages(card[0] if card else "", root, w, rates,
                                                     traced, checked)
        launches.update(stage_launches)
        for kind, rows in stage_results.items():
            results[kind] += rows
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    header(MESH_HEAD)
    launches.update(mesh_phase(card[0] if card else "", tr["losses"][:MESH_STEPS]))
    torch.cuda.empty_cache()

    # last, so that its child processes and its 3.5 GB of files touch no earlier measurement
    header("[entry] the command-line program and the daemon at full width, from reference-layout "
        "files written from the serving phase's weights (the same seed, bf16)")
    pipe = randomize_pipeline_(build_pipeline(OBJ_YAML, stage="obj", seed=0,
                                              allow_untrained_cm=True)[0], 0)
    launches.update(entry(pipe, card[0] if card else ""))
    del pipe
    torch.cuda.empty_cache()

    header(TOOLS_HEAD)  # after entry: its child processes and files touch no earlier measurement
    launches.update(tools_export(card[0] if card else ""))
    header("[done]")

    print(json.dumps({"kernels": summarise(results, launches)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
