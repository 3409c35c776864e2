"""Data- and frame-parallel serving on the CPU: the port's denoise_loop on a
gloo mesh of 4 ranks against its own single-process run (one torch thread on
both sides) and the JAX package's single-device denoise_loop (1e-3, as
tests/test_torch_sampler.py).  Data-parallel runs the production fp32 and
equals the single-process run bit for bit (the same batch-1 programs).
Frame-parallel runs in float64 and holds the single-process float64 run to
1e-5: in fp32 a batch-1 UNet forward already differs from the stacked pair's
by ~1e-5 on a CPU (GEMM blocking; 0.0 in float64), and guidance 8
multiplies that over the steps, so fp32 would test rounding, not the mesh.

The tiny obj stage of test_torch_sampler.py (motion modules at level 0,
4 frames at 64x64, 3 steps, the OMC gate shut at the last step), the JAX
UNet's seeded weights carried into the port; the port's own seeded text and
pose encoders and ObjectAdapter make the context, pose and traj features that
both packages are handed.  Data-parallel: 4 prompts over data = 4, each
prompt's JAX reference a batch-1 run of the same compiled program.
Frame-parallel: one prompt over data = 2 (the CFG pair) x sp = 2 (the
frames).  Every mode runs on the mesh; the JAX programs of exact DDIM with
OMC and of turbo with DPM++ (DeepCache, CFG-cache and the second-order
solver at once) compile in a thread while the ranks run.  The other modes'
single-process runs are the ones test_torch_sampler.py holds to JAX on these
shapes and weights' structure; a JAX compile of each here would take the
file past its time (13-25 s each on an 8-core CPU).
"""

import concurrent.futures
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.diffusion import DiffusionSchedule as JSchedule
from synfmc_tpu.pipelines.animation import denoise_loop as jax_denoise
from synfmc_tpu_torch.geometry.plucker import plucker_embedding
from synfmc_tpu_torch.interop.torch_port import load_jax_params
from synfmc_tpu_torch.parallel.mesh import Axis
from synfmc_tpu_torch.pipelines.animation import decode_latents, denoise_loop
from synfmc_tpu_torch.pipelines.factory import build_pipeline, randomize_pipeline_
from synfmc_tpu_torch.utils.traj_features import build_adapter_inputs
from tests._torch_mesh import RankPool
from tests.test_torch_modules import randomize, shapes
from tests.test_torch_sampler import FAST, OMCM, STEPS, F, H, W, obj_config, obj_inputs
from tests.test_torch_slice import jax_models

CHS = obj_config()["model_overrides"]["block_out_channels"]
PROMPTS = ["a turtle paddles through a coral reef", "a yellow bird hops along the road",
           "a knight marches across a field", "a blue dragon soars, seen from behind"]
MD_WINDOWS, MD_OVERLAP = 2, 2
MODES = {
    "omc": dict(),
    "dpmpp": dict(solver="dpmpp_2m"),
    "deepcache2": dict(deepcache_interval=2),
    "cfgcache2": dict(cfg_cache_interval=2),
    "turbo2_dpmpp": dict(deepcache_interval=2, cfg_cache_interval=2, solver="dpmpp_2m"),
    "multidiff": dict(multidiff_total_steps=MD_WINDOWS, multidiff_overlaps=MD_OVERLAP),
}
FP_MODES = [m for m in MODES if m != "multidiff"]
JAX_MODES = ("omc", "turbo2_dpmpp")
PORT_TOL, JAX_TOL = 1e-5, 1e-3
RESULTS: dict = {}  # (mesh kind, mode) -> the mesh run's latents, for the JAX tests last


def _camera(f, shift):
    intr = np.broadcast_to(np.array([W, H, 0, 0], np.float32), (1, f, 4)).copy()
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, f, 1, 1))
    c2w[..., 0, 3] = np.linspace(0.0, 0.6, f) + shift
    return torch.from_numpy(intr), torch.from_numpy(c2w)


@pytest.fixture(scope="module")
def case():
    """The port pipeline with the JAX UNet's weights, and per mode the
    whole inputs of the 4 prompts (numpy)."""
    cfg = obj_config()
    unet = jax_models(cfg)["unet"]
    pose0 = [jnp.zeros((1, F, H // 8 // 2**i, W // 8 // 2**i, c)) for i, c in enumerate(CHS)]
    params = randomize(shapes(unet, jax.random.PRNGKey(0), jnp.zeros((1, F, H // 8, W // 8, 4)),
                              jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                              pose_features=pose0), seed=1)
    pipe, _ = build_pipeline(cfg, stage="obj", device="cpu", seed=0, allow_untrained_cm=True)
    randomize_pipeline_(pipe, 5)
    load_jax_params(pipe.unet, params, "unet")
    rng = np.random.default_rng(6)
    md_frames = MD_WINDOWS * (F - MD_OVERLAP) + MD_OVERLAP
    inputs = {}
    with torch.inference_mode():
        context = pipe.encode_prompt(PROMPTS).numpy()
        for name, f in (("one", F), ("md", md_frames)):
            pose = [pipe.encode_pose(plucker_embedding(*_camera(f, 0.1 * i), H, W))
                    for i in range(len(PROMPTS))]
            traj = None
            if name == "one":
                traj = []
                for _ in PROMPTS:
                    info, masks = obj_inputs(rng)
                    feats, mask = build_adapter_inputs(torch.from_numpy(info),
                                                       torch.from_numpy(masks))
                    traj.append(pipe.encode_traj(feats, mask, F))
                traj = [torch.cat(t).numpy() for t in zip(*traj)]
            inputs[name] = {
                "latents": rng.normal(size=(len(PROMPTS), f, H // 8, W // 8, 4)).astype(np.float32),
                "context": context,
                "pose": [torch.cat(p).numpy() for p in zip(*pose)],
                "traj": traj,
            }
    states = {name: {k: v.numpy() for k, v in m.state_dict().items()}
              for name, m in (("unet", pipe.unet), ("vae", pipe.vae))}
    pipe64 = types.SimpleNamespace(unet=copy.deepcopy(pipe.unet).double(),
                                   vae=copy.deepcopy(pipe.vae).double(), schedule=pipe.schedule)
    return dict(cfg=cfg, unet=unet, params=params, pipe=pipe, pipe64=pipe64, inputs=inputs,
                states=states,
                schedule=JSchedule.from_config(**cfg["noise_scheduler_kwargs"]))


def _mode_inputs(case, mode):
    return case["inputs"]["md" if mode == "multidiff" else "one"]


def _prompt(inp, i):
    """Prompt i's batch-1 inputs: its latents, [uncond_i, cond_i], features."""
    b = inp["latents"].shape[0]
    one = lambda xs: None if xs is None else [x[i:i + 1] for x in xs]
    return {"latents": inp["latents"][i:i + 1],
            "context": inp["context"][[i, b + i]], "pose": one(inp["pose"]),
            "traj": one(inp["traj"])}


def _loop_kw(mode):
    return dict(num_inference_steps=STEPS, guidance_scale=8.0, omcm_min_step=OMCM,
                window_length=F, **MODES[mode])


@pytest.fixture(scope="module")
def jax_refs(case):
    """Every mode's JAX single-device program, compiled in a thread each,
    run on each prompt's batch-1 inputs: futures of (prompts, ...) arrays."""
    def run(mode):
        inp = _mode_inputs(case, mode)
        kw = _loop_kw(mode)
        fn = jax.jit(lambda p, l, c, po, tr: jax_denoise(case["unet"], p, case["schedule"], l, c,
                                                         pose_features=po, traj_features=tr,
                                                         **kw))
        outs, compiled = [], None
        for i in range(len(PROMPTS)):
            one = _prompt(inp, i)
            args = (case["params"], jnp.asarray(one["latents"]), jnp.asarray(one["context"]),
                    [jnp.asarray(p) for p in one["pose"]],
                    None if one["traj"] is None else [jnp.asarray(t) for t in one["traj"]])
            if compiled is None:
                compiled = fn.lower(*args).compile(compiler_options=FAST)
            outs.append(np.asarray(compiled(*args)))
        return np.concatenate(outs)

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {mode: pool.submit(run, mode) for mode in JAX_MODES}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(case, jax_refs):
    """4 ranks holding the case's pipeline (the JAX programs compile meanwhile)."""
    pool = RankPool(4)
    pool.run("tests._torch_mesh:load_pipe", case["cfg"], case["states"])
    yield pool
    pool.close()


def _single(case, mode, inp, dtype=torch.float32):
    """The port's single-process run, prompt by prompt (batch 1, as the
    data-parallel ranks and the JAX references run), in ``dtype``."""
    pipe = case["pipe"] if dtype == torch.float32 else case["pipe64"]
    t = lambda xs: None if xs is None else [torch.from_numpy(x).to(dtype) for x in xs]
    outs, threads = [], torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs
    try:
        for i in range(inp["latents"].shape[0]):
            one = _prompt(inp, i)
            outs.append(denoise_loop(pipe.unet, pipe.schedule,
                                     torch.from_numpy(one["latents"]).to(dtype),
                                     torch.from_numpy(one["context"]).to(dtype),
                                     pose_features=t(one["pose"]), traj_features=t(one["traj"]),
                                     **_loop_kw(mode)).numpy())
    finally:
        torch.set_num_threads(threads)
    return np.concatenate(outs)


def _decode_single(case, latents):
    pipe = case["pipe"] if latents.dtype == np.float32 else case["pipe64"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.inference_mode():
            return decode_latents(pipe.vae, torch.from_numpy(latents[:, :, :4, :4]),
                                  decode_chunk=2).numpy()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", list(MODES))
def test_data_parallel_denoise_loop(case, ranks, mode):
    """4 prompts over data = 4: every rank holds the whole result, equal bit
    for bit across ranks; each prompt's latents against its single-process
    and JAX runs."""
    inp = dict(_mode_inputs(case, mode), decode=mode == "omc")
    outs = ranks.run("tests._torch_mesh:denoise", inp, _loop_kw(mode), {"data": 4, "sp": 1})
    got = outs[0]["latents"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["latents"], got)
    assert outs[0]["calls"] == {"all_gather_into_tensor": 1}  # the batch, once
    single = _single(case, mode, inp)
    np.testing.assert_allclose(got, single, atol=PORT_TOL, rtol=0)
    RESULTS["data", mode] = got
    if inp["decode"]:
        np.testing.assert_allclose(outs[3]["frames"], _decode_single(case, single),
                                   atol=PORT_TOL, rtol=0)


@pytest.mark.parametrize("mode", FP_MODES)
def test_frame_parallel_denoise_loop(case, ranks, mode):
    """Prompt 0 over data = 2 (the CFG pair) x sp = 2 (2 frames a rank):
    every rank holds the whole latents, equal across ranks; against the
    single-process and JAX runs.  Each step exchanges twice per motion
    module and gathers the pair once; the cached CFG steps too."""
    inp = _mode_inputs(case, mode)
    one = dict(_prompt(inp, 0), decode=mode == "omc")
    outs = ranks.run("tests._torch_mesh:denoise", one, _loop_kw(mode), {"data": 2, "sp": 2},
                     "float64")
    got = outs[0]["latents"]
    assert got.shape == one["latents"].shape and got.dtype == np.float64
    for o in outs[1:]:
        np.testing.assert_array_equal(o["latents"], got)
    single = _single(case, mode, one, torch.float64)
    np.testing.assert_allclose(got, single, atol=PORT_TOL, rtol=0)
    RESULTS["frames", mode] = got
    # motion modules at level 0 alone: down_blocks[0]'s 2 and up_blocks[3]'s
    # 3, in the full and the shallow forward alike, 2 exchanges each; the
    # uncond ranks (0 and 1) skip CFG-cache's cached step
    cond_only = MODES[mode].get("cfg_cache_interval", 1) > 1
    for r, o in enumerate(outs):
        forwards = STEPS - (cond_only and r < 2)
        assert o["calls"] == {"all_gather_into_tensor": STEPS + 1,  # the pair a step, frames
                              "all_to_all_single": 2 * 5 * forwards}, (r, o["calls"])
    if one["decode"]:
        np.testing.assert_allclose(outs[1]["frames"], _decode_single(case, single),
                                   atol=PORT_TOL, rtol=0)


def test_frame_parallel_refuses_multidiff_and_a_wrong_data_axis(case):
    """The JAX sampler's asserts, before any collective (a mesh stand-in)."""
    pipe, inp = case["pipe"], _prompt(case["inputs"]["md"], 0)
    mesh = types.SimpleNamespace(
        count=lambda a: 2, axis=lambda a: Axis(a, None, (0, 1), 0))
    args = (pipe.unet, pipe.schedule, torch.from_numpy(inp["latents"]),
            torch.from_numpy(inp["context"]))
    with pytest.raises(ValueError, match="multidiff_total_steps == 1"):
        denoise_loop(*args, mesh=mesh, **_loop_kw("multidiff"))
    two = torch.from_numpy(np.concatenate([inp["latents"]] * 2))
    with pytest.raises(ValueError, match="mesh data == 2\\*batch"):
        denoise_loop(pipe.unet, pipe.schedule, two, torch.cat([args[3]] * 2), mesh=mesh,
                     **_loop_kw("omc"))


@pytest.mark.parametrize("mode", JAX_MODES)
def test_mesh_runs_match_jax(jax_refs, mode):
    """The data-parallel run's 4 prompts and the frame-parallel run's one
    against the JAX package's single-device denoise_loop."""
    want = jax_refs[mode].result()
    np.testing.assert_allclose(RESULTS["data", mode], want, atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(RESULTS["frames", mode], want[:1], atol=JAX_TOL, rtol=0)
