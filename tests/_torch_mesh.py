"""A pool of spawned ranks in one gloo process group, for the port's mesh tests.

``RankPool(world)`` starts ``world`` processes (``torch.multiprocessing``
spawn, one torch thread each) that join one gloo group on the CPU through
``parallel.mesh.init_distributed``, exactly as ranks under ``python -m
torch.distributed.run`` do.  ``pool.run("module:function", *args)`` runs the
function on every rank with the same arguments and returns the ranks'
results in rank order; the function builds its own ``Mesh`` (the layout it
tests).  Each call has a timeout of its own: a rank that raises or a call
that hangs fails that call, and the pool is restarted for the next one.

The rank-side functions live here too: they import torch and the port only
(no JAX), so that a rank starts in a few seconds.
"""

from __future__ import annotations

import importlib
import os
import queue
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

CALL_TIMEOUT_S = 90.0
GROUP_TIMEOUT_S = 60.0  # gloo's own: a rank left waiting in a collective raises


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, parent: int, jobs, results) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from synfmc_tpu_torch.parallel.mesh import init_distributed

    init_distributed(backend="gloo", device="cpu", timeout_s=GROUP_TIMEOUT_S)
    while True:
        try:
            job = jobs.get(timeout=5.0)
        except queue.Empty:
            if os.getppid() != parent:  # the test process is gone
                break
            continue
        if job is None:
            break
        target, args = job
        try:
            mod, name = target.split(":")
            out = getattr(importlib.import_module(mod), name)(*args)
            results.put((rank, True, out))
        except BaseException:  # reported to the test, which fails
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int):
        self.world = world
        self._procs = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        port = _free_port()
        self._jobs = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        # not daemonic: a rank starts the data loader's worker processes, as
        # a rank under torch.distributed.run does
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, self.world, port, os.getpid(), self._jobs[r],
                                         self._results))
                       for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, target: str, *args, timeout: float = CALL_TIMEOUT_S) -> list:
        if not self._procs:
            self._start()
        for q in self._jobs:
            q.put((target, args))
        out, errors = {}, []
        try:
            while len(out) + len(errors) < self.world:
                rank, ok, value = self._results.get(timeout=timeout)
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    timeout = min(timeout, 5.0)  # the others may be stuck in a collective
        except queue.Empty:
            missing = sorted(set(range(self.world)) - set(out))
            errors.append(f"ranks {missing} gave no result within the call's timeout")
        if errors:
            self.close()
            raise AssertionError(f"{target} failed:\n" + "\n".join(errors))
        return [out[r] for r in range(self.world)]

    def close(self) -> None:
        for q in getattr(self, "_jobs", []):
            q.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
        self._procs = []


# ---------------------------------------------------------------- rank side

_PIPES: dict = {}


def numpy(t):
    """A tensor as numpy in its own type (bf16 as fp32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def layout(sizes: dict) -> dict:
    """This rank's coordinates and each axis line's ranks."""
    from synfmc_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(sizes)
    return {name: (ax.index, ax.ranks) for name, ax in mesh.axes.items()}


def exchange(x: np.ndarray, weight: np.ndarray) -> dict:
    """frames_to_rows -> a row-wise product -> rows_to_frames on this rank's
    frames of ``x`` (b, f, h, w, c) over an sp axis of the whole world, and
    the gradient of a weighted sum back to the frames and the weight."""
    from synfmc_tpu_torch.parallel.collectives import frames_to_rows, row_splits, rows_to_frames
    from synfmc_tpu_torch.parallel.mesh import Mesh

    sp = Mesh({"sp": int(torch.distributed.get_world_size())}).axis("sp")
    b, f, h, w, c = x.shape
    fl = f // sp.size
    xs = torch.from_numpy(x[:, sp.index * fl:(sp.index + 1) * fl].copy()).requires_grad_(True)
    wt = torch.from_numpy(weight).requires_grad_(True)
    splits = row_splits(b * h * w, sp.size)
    rows = frames_to_rows(xs, sp.group, sp.index, splits)
    mixed = torch.einsum("nfc,fg->ngc", rows, wt)  # mixes frames: needs whole rows
    back = rows_to_frames(mixed, sp.group, sp.index, splits, xs.shape)
    (back * torch.arange(back.numel()).reshape(back.shape)).sum().backward()
    return {"splits": splits, "rows": numpy(rows), "back": numpy(back), "dx": numpy(xs.grad),
            "dw": numpy(wt.grad)}


def load_pipe(cfg: dict, states: dict) -> bool:
    """Build the tiny obj-stage pipeline of ``cfg`` and load ``states``
    (numpy state dicts of its unet and vae) into it, for the calls after."""
    from synfmc_tpu_torch.pipelines.factory import build_pipeline

    pipe, _ = build_pipeline(cfg, stage="obj", device="cpu", seed=0, allow_untrained_cm=True)
    for name, module in (("unet", pipe.unet), ("vae", pipe.vae)):
        module.load_state_dict({k: torch.from_numpy(v) for k, v in states[name].items()})
    _PIPES["pipe"] = pipe
    return True


def denoise(inputs: dict, kw: dict, mesh_sizes: dict, dtype: str = "float32") -> dict:
    """The port's denoise_loop under a serving mesh of ``mesh_sizes`` on the
    whole inputs, the loaded pipeline's modules and the inputs in ``dtype``,
    plus the mesh-aware decode of a frame slice; every rank returns what it
    holds, with the collectives' counters."""
    from synfmc_tpu_torch.parallel import collectives
    from synfmc_tpu_torch.parallel.mesh import Mesh
    from synfmc_tpu_torch.pipelines.animation import decode_latents, denoise_loop

    dt = getattr(torch, dtype)
    pipe = _PIPES["pipe"]
    pipe.unet.to(dt)
    pipe.vae.to(dt)
    mesh = Mesh(mesh_sizes)
    t = lambda xs: None if xs is None else [torch.from_numpy(x).to(dt) for x in xs]
    collectives.reset_counters()
    out = denoise_loop(pipe.unet, pipe.schedule, torch.from_numpy(inputs["latents"]).to(dt),
                       torch.from_numpy(inputs["context"]).to(dt), pose_features=t(inputs["pose"]),
                       traj_features=t(inputs.get("traj")), mesh=mesh, **kw)
    assert pipe.unet.frame_shard is None, "the loop must restore the UNet's frame shard"
    res = {"calls": dict(collectives.CALLS)}
    if inputs.get("decode"):
        res["frames"] = numpy(decode_latents(pipe.vae, out[:, :, :4, :4], decode_chunk=2,
                                             mesh=mesh))
    res["latents"] = out.cpu().numpy()  # in its own type
    return res


def stop_flag(flags: list) -> list:
    """sync_stop_flag over the world for each of ``flags`` (rank -> bool)."""
    from synfmc_tpu_torch.parallel.mesh import rank, sync_stop_flag

    return [sync_stop_flag(bool(f[rank()])) for f in flags]


def _cam_models(cfg: dict, states: dict, dtype):
    """The tiny cam stage's modules with ``states`` (numpy state dicts) in
    ``dtype``, the trainable set marked: (models, trainable)."""
    from synfmc_tpu_torch.pipelines.factory import build_models
    from synfmc_tpu_torch.training.params import partition_params, stage2_cmc_unet_trainable

    models = build_models(cfg)
    for name, module in models.items():
        module.load_state_dict({k: torch.from_numpy(v) for k, v in states[name].items()})
        module.to(dtype)
    trainable = {**partition_params(models["unet"], stage2_cmc_unet_trainable, "unet."),
                 **partition_params(models["pose_encoder"], lambda n: True, "pose_encoder.")}
    for name in ("vae", "text"):
        partition_params(models[name], lambda n: False)
    return models, trainable


def cam_steps(cfg: dict, states: dict, step_cfg: dict, batches: list, draws: list,
              mesh_sizes: dict, lr: float, dtype: str = "float32", accum: int = 1) -> dict:
    """Stage-2 steps on a training mesh of ``mesh_sizes``: each of
    ``batches`` / ``draws`` (numpy dicts) is a GLOBAL batch and its draws, of
    which this rank takes its part (``accum`` of them a step).  Returns the
    first step's averaged gradients and metrics, then the fp32 masters (whole:
    under fsdp gathered from the ranks' rows) and their checksum after each
    step, the working weights' checksum after each step, and this rank's own
    masters and moments at the end with the rows it owns and their bytes."""
    from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule
    from synfmc_tpu_torch.parallel.mesh import gather_shards, shard, training_mesh
    from synfmc_tpu_torch.training.optim import make_optimizer
    from synfmc_tpu_torch.training.steps import (
        CamDraws,
        StepConfig,
        average_over,
        init_train_state,
        make_accumulating_step,
        make_cam_grads_fn,
        state_nbytes,
        step_from_grads,
    )
    from synfmc_tpu_torch.training.trainers import checksum

    dt = getattr(torch, dtype)
    mesh = training_mesh(**mesh_sizes)
    models, trainable = _cam_models(cfg, states, dt)
    schedule = DiffusionSchedule.from_config(**cfg["noise_scheduler_kwargs"])
    grads_fn = make_cam_grads_fn(models["unet"], models["pose_encoder"], models["vae"],
                                 models["text"], schedule, StepConfig(**step_cfg),
                                 sp=mesh.axis("sp"))

    def local(batch, draw):
        b = batch["pixel_values"].shape[0]
        part = shard(b, mesh.axis("data"), "samples")
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v))
            t = t.long() if k.endswith("_ids") else t.to(dt) if t.is_floating_point() else t
            out[k] = t if k == "null_ids" else t[part]
        d = CamDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draw.items()})
        d = d.part(part, b)
        d.vae_eps, d.noise = d.vae_eps.to(dt), d.noise.to(dt)
        return out, d

    parts = [local(b, d) for b, d in zip(batches, draws)]
    state = init_train_state(trainable, make_optimizer(lr), mesh=mesh)
    whole = gather_shards if state.shards is None else (
        lambda d: gather_shards(state.shards.wrap(d)))
    # before the first update AdamW holds no moments: zeros of this rank's shapes
    before = whole(dict(zip(state.trainable, state.optimizer.moments()[1])))
    g, m = average_over(*grads_fn(trainable, *parts[0]), mesh.world_group, state.shards)
    res = {"grads": {n: numpy(v) for n, v in whole(g).items()},
           "metrics": {k: float(v) for k, v in m.items()}, "masters": [], "checksums": [],
           "working": [], "moments_before": {n: tuple(v.shape) for n, v in before.items()}}
    step_fn = (make_accumulating_step(grads_fn, accum, mesh.world_group) if accum > 1
               else step_from_grads(grads_fn, mesh.world_group))
    for i in range(0, len(parts), accum):
        group = parts[i:i + accum]
        if accum > 1:
            state, metrics = step_fn(state, [p[0] for p in group], [p[1] for p in group])
        else:
            state, metrics = step_fn(state, *group[0])
        masters = whole(state.masters)
        res["masters"].append({n: p.detach().cpu().numpy().copy() for n, p in masters.items()})
        res["checksums"].append(checksum(masters.values()))
        res["working"].append(checksum(state.trainable.values()))
        res.setdefault("losses", []).append(float(metrics["loss"]))
    exp_avg, exp_avg_sq = state.optimizer.moments()
    names = list(state.trainable)
    rows = (state.shards.rows if state.shards is not None else dict.fromkeys(names))
    res["own"] = {"masters": {n: numpy(state.masters[n]) for n in names},
                  "exp_avg": dict(zip(names, map(numpy, exp_avg))),
                  "exp_avg_sq": dict(zip(names, map(numpy, exp_avg_sq))),
                  "rows": {n: None if r is None else (r.start, r.stop) for n, r in rows.items()},
                  "bytes": state_nbytes(state)}
    res["moments"] = {k: {n: numpy(v) for n, v in whole(dict(zip(names, t))).items()}
                      for k, t in (("exp_avg", exp_avg), ("exp_avg_sq", exp_avg_sq))}
    return res


def mesh_error(sizes: dict) -> str:
    """The error a mesh that does not fit the world raises."""
    from synfmc_tpu_torch.parallel.mesh import Mesh

    try:
        Mesh(sizes)
    except ValueError as e:
        return str(e)
    return ""


def run_train(cfg: dict, max_steps: int, sigterm_rank_at=None) -> dict:
    """``trainers.train("cam", cfg)`` on this rank (the config's mesh); with
    ``sigterm_rank_at`` = (rank, step) that rank sends itself SIGTERM after
    that step.  Returns the summary without its tensors."""
    import signal

    from synfmc_tpu_torch.parallel.mesh import rank
    from synfmc_tpu_torch.training.trainers import train

    def on_step(state, metrics, draws):
        if sigterm_rank_at is not None and (rank(), state.step) == tuple(sigterm_rank_at):
            os.kill(os.getpid(), signal.SIGTERM)

    out = train("cam", cfg, max_steps=max_steps, device="cpu", on_step=on_step)
    keep = ("steps", "run_dir", "preempted", "losses", "checksums", "loss_history", "assembled",
            "state_bytes")
    return {k: out.get(k) for k in keep}
