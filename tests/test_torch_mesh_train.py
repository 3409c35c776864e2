"""Data- and frame-parallel training on the CPU: 2 ranks in one gloo group.

The stage-2 step of test_torch_train.py on a lighter case (two UNet levels,
motion modules at level 0, 64x64 px, 2 frames, batch 2): the same seeded
weights, batch and JAX-derived draws go through
- the JAX package's grads function on the concatenated batch (compiled in a
  thread while the ranks run; test_torch_train.py's tolerances);
- the port's single-process step (``training_mesh()`` of one rank);
- the port on ``mesh: {data: 2}`` (a sample a rank), ``{sp: 2}`` (a frame
  a rank, the motion module's exchange in the forward and the backward),
  ``{fsdp: 2}`` (ZeRO-1: each rank the masters and moments of its dim-0 rows,
  gradients reduce-scattered, the working weights all-gathered) and, on 4
  ranks, ``{fsdp: 2, sp: 2}``.
The port's runs are float64, so that the mesh is held to the single process
at 1e-5 of each gradient's largest magnitude plus 1e-3 relative (in fp32 the
ranks' other GEMM shapes alone move the sums by more; the attention's plain
versions keep fp32 logits even here, which leaves ~1e-5 of the largest
magnitude on a few small pose-encoder gradients), the masters after the
AdamW steps within 2 lr (phase 5 of chip_smoke.py: Adam's normalised update
turns a rounding-sized difference of a near-zero gradient into up to lr);
the replicas' masters and checksums equal bit for bit after every step.  Then the trainer itself on a fixture
dataset over ``data: 2``: a SIGTERM on rank 1 stops both ranks at the same
step, rank 0 alone writes the checkpoints, the ranks resume from them
exactly, and each rank logs to its own file; and over ``fsdp: 2``: a SIGTERM
on rank 1 stops both ranks with one gather of the shards, whose ``state.pt``
matches a one-process run's, resumes in one process, and one written in one
process resumes under fsdp.
"""

import concurrent.futures
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synfmc_tpu.diffusion import DiffusionSchedule as JSchedule
from synfmc_tpu.training.params import partition_params as jax_partition
from synfmc_tpu.training.params import stage2_cmc_unet_trainable as jax_stage2
from synfmc_tpu.training.steps import StepConfig as JStepConfig
from synfmc_tpu.training.steps import make_cam_grads_fn as jax_cam_grads_fn
from synfmc_tpu_torch.data.fixture import build_synthetic_dataset
from synfmc_tpu_torch.data.tokenizer import HashTokenizer
from synfmc_tpu_torch.interop.torch_port import jax_state_dict, load_jax_params
from synfmc_tpu_torch.pipelines.factory import build_models
from synfmc_tpu_torch.training import checkpoint as ckpt
from synfmc_tpu_torch.training.trainers import train
from tests import _torch_mesh
from tests._torch_mesh import RankPool
from tests.test_torch_modules import randomize, shapes
from tests.test_torch_slice import jax_models, tiny_config
from tests.test_torch_trainer import tiny_config as trainer_config

B, F, H, W = 2, 2, 64, 64
CHS = [32, 64]
LR = 1e-3
CFG = dict(cfg_random_null_text_ratio=0.5, background_caption_prob=1.0, apply_masked_loss=True,
           invert_loss_mask=True, mask_loss_weight=1.0, sd_loss_weight=0.6,
           appearance_debias=0.5, sample_height=H, sample_width=W)
KEY_SEEDS = (22, 5)  # 22: sample 0's camera and sample 1's text dropped (test_torch_train.py)
MESHES = {"data": {"data": 2}, "sp": {"sp": 2}, "fsdp": {"fsdp": 2}}
MESHES4 = {"fsdp+sp": {"fsdp": 2, "sp": 2}}  # on a pool of 4 ranks


def _batch(seed):
    rng = np.random.default_rng(seed)
    tok = HashTokenizer()
    rt = np.tile(np.eye(4, dtype=np.float32)[:3].reshape(12), (B, F, 1))
    rt[..., 3] = np.linspace(0.0, 0.5, F)
    rt[1, :, 11] = 0.2
    mask = np.zeros((B, F, H, W, 1), np.float32)
    mask[:, :, 16:48, 20:50] = 1.0
    return {
        "pixel_values": rng.uniform(-1, 1, (B, F, H, W, 3)).astype(np.float32),
        "input_ids": tok(["a knight marches across a field", "a blue dragon soars"]),
        "background_ids": tok(["a grassy field", "an empty sky"]),
        "null_ids": tok([""])[0],
        "camera_rt": rt,
        "intrinsics": np.tile(np.array([W, H, 0, 0], np.float32), (B, F, 1)),
        "obj_union_mask": mask,
        "flip_flag": np.array([True, False]),
    }


@jax.jit
def _jax_draws(key):
    """The JAX step's draws (synfmc_tpu/training/steps.py:227-237)."""
    cfg = JStepConfig(**CFG)
    r = jax.random.split(key, 8)
    lat = (B, F, H // 8, W // 8, 4)
    return {
        "use_background": jax.random.uniform(r[0]) < cfg.background_caption_prob,
        "text_drop": jax.random.uniform(r[1], (B,)) < cfg.cfg_random_null_text_ratio,
        "camera_drop": jax.random.uniform(r[2], (B,)) < cfg.cfg_random_null_text_ratio,
        "vae_eps": jax.random.normal(r[3], (B * F, *lat[2:]), jnp.float32),
        "noise": jax.random.normal(r[4], lat, jnp.float32),
        "timesteps": jax.random.randint(r[5], (B,), 0, 1000),
        "anchor": jax.random.randint(r[7], (B,), 0, F),
    }


def _config():
    cfg = tiny_config()
    cfg["model_overrides"]["block_out_channels"] = CHS
    cfg["unet_additional_kwargs"]["motion_module_resolutions"] = [1]
    return cfg


@pytest.fixture(scope="module")
def case():
    """Seeded JAX weights carried into the port (numpy state dicts), two
    global batches with their draws, and the JAX grads of the first in a
    background thread."""
    cfg = _config()
    models = jax_models(cfg, CHS)
    key = jax.random.PRNGKey(0)
    pose0 = [jnp.zeros((1, F, H // 8 // 2**i, W // 8 // 2**i, c)) for i, c in enumerate(CHS)]
    params = {
        "unet": randomize(shapes(models["unet"], key, jnp.zeros((1, F, H // 8, W // 8, 4)),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                                 pose_features=pose0), seed=1)["params"],
        "vae": randomize(shapes(models["vae"], key, jnp.zeros((1, 32, 32, 3))), seed=2)["params"],
        "clip_text": randomize(shapes(models["clip_text"], key, jnp.zeros((1, 77), jnp.int32)),
                               seed=3)["params"],
        "pose_encoder": randomize(shapes(models["pose_encoder"], key,
                                         jnp.zeros((1, F, H, W, 6))), seed=4)["params"],
    }
    port = build_models(cfg)
    states = {}
    for name, jname in (("unet", "unet"), ("vae", "vae"), ("text", "clip_text"),
                        ("pose_encoder", "pose_encoder")):
        load_jax_params(port[name], params[jname], jname)
        states[name] = {k: v.numpy() for k, v in port[name].state_dict().items()}
    batches = [_batch(11), _batch(12)]
    keys = [jax.random.PRNGKey(s) for s in KEY_SEEDS]
    draws = [{k: np.asarray(v) for k, v in _jax_draws(k_).items()} for k_ in keys]

    def jax_grads():
        t_unet, f_unet = jax_partition(params["unet"], jax_stage2)
        trainable = {"unet": t_unet, "pose_encoder": params["pose_encoder"]}
        frozen = {"unet": f_unet, "vae": {"params": params["vae"]},
                  "text": {"params": params["clip_text"]}}
        fn = jax_cam_grads_fn(models["unet"], models["pose_encoder"], models["vae"],
                              models["clip_text"],
                              JSchedule.from_config(**cfg["noise_scheduler_kwargs"]),
                              JStepConfig(**CFG))
        jbatch = {k: jnp.asarray(v) for k, v in batches[0].items()}
        compiled = jax.jit(fn).lower(trainable, frozen, jbatch, keys[0]).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        grads, metrics = compiled(trainable, frozen, jbatch, keys[0])
        named = {**{"unet." + k: v for k, v in jax_state_dict(grads["unet"], "unet").items()},
                 **{"pose_encoder." + k: v
                    for k, v in jax_state_dict(grads["pose_encoder"], "pose_encoder").items()}}
        return named, {k: float(v) for k, v in metrics.items()}

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(jax_grads)
    yield dict(cfg=cfg, states=states, batches=batches, draws=draws, jax=future)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """A 3-sequence dataset (on data = 2 the ranks' shards are cut to one
    sample each)."""
    root = tmp_path_factory.mktemp("mesh_data")
    return build_synthetic_dataset(str(root), num_seqs=3, num_objects=2, num_frames=48)


@pytest.fixture(scope="module")
def trainer_runs(case, ranks, fixture, tmp_path_factory):
    """On data = 2: 4 steps; 4 steps with a SIGTERM on rank 1 after step 2;
    then resume_from: auto to 4.  (``case`` first: its JAX program compiles
    meanwhile.)"""
    root = tmp_path_factory.mktemp("mesh_train")
    cfg = lambda out, **kw: trainer_config(fixture, root / out, mesh={"data": 2},
                                           checkpointing_steps=2, num_workers=1,
                                           prefetch_batches=0, **kw)
    return {"full": ranks.run("tests._torch_mesh:run_train", cfg("full"), 4),
            "stopped": ranks.run("tests._torch_mesh:run_train", cfg("resume"), 4, (1, 2)),
            "resumed": ranks.run("tests._torch_mesh:run_train", cfg("resume", resume_from="auto"),
                                 4)}


def test_sigterm_on_one_rank_stops_both_at_the_same_step(trainer_runs):
    stopped = trainer_runs["stopped"]
    assert [r["steps"] for r in stopped] == [2, 2]
    assert all(r["preempted"] for r in stopped)
    assert stopped[0]["run_dir"] == stopped[1]["run_dir"]


def test_rank0_checkpoints_resume_exactly(trainer_runs):
    full, stopped, resumed = (trainer_runs[k] for k in ("full", "stopped", "resumed"))
    # the resumed run writes into the same directory when it starts in the same
    # minute (the directory's name), else into the next minute's; a rank other
    # than 0 that wrote would have raised (checkpoint.save_native)
    ckpts = sorted(os.path.basename(p) for d in {stopped[0]["run_dir"], resumed[0]["run_dir"]}
                   for p in glob.glob(os.path.join(d, "checkpoints", "*")))
    assert ckpts == ["cmcm-step-2.ckpt", "cmcm-step-4.ckpt", "step-2", "step-4"], ckpts
    for r in range(2):
        assert resumed[r]["steps"] == 4
        assert resumed[r]["losses"] == full[r]["losses"][2:]
        assert resumed[r]["checksums"]["trainable"][-1] == full[r]["checksums"]["trainable"][-1]
    assert full[0]["checksums"] == full[1]["checksums"]
    a = ckpt.restore_native(os.path.join(full[0]["run_dir"], "checkpoints", "step-4"))
    b = ckpt.restore_native(os.path.join(resumed[0]["run_dir"], "checkpoints", "step-4"))
    assert all(torch.equal(a["masters"][n], b["masters"][n]) for n in a["masters"])


def test_each_rank_logs_to_its_own_file(trainer_runs):
    run_dir = trainer_runs["full"][0]["run_dir"]
    logs = sorted(os.path.basename(p) for p in glob.glob(os.path.join(run_dir, "log.txt*")))
    assert logs == ["log.txt", "log.txt.rank1"]
    for name in logs:
        with open(os.path.join(run_dir, name)) as fh:
            assert "step 4/4" in fh.read()


def _one_process(fn, *args, **kw):
    """``fn`` at one torch thread, as a rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fsdp_trainer_runs(case, ranks, fixture, tmp_path_factory):
    """On fsdp = 2 against one process (one torch thread, as a rank): one
    process 4 steps, checkpoints at 2 and 4; fsdp 4 steps with a SIGTERM on
    rank 1 after step 2 (the final save's gather at step 2); one process
    from that checkpoint to 4; fsdp from the one process's step 2 to 4
    (the periodic checkpoint's gather at step 4)."""
    root = tmp_path_factory.mktemp("fsdp_train")
    cfg = lambda out, **kw: trainer_config(fixture, root / out, num_workers=1, prefetch_batches=0,
                                           **kw)
    step2 = lambda r: os.path.join(r["run_dir"], "checkpoints", "step-2")
    runs = {"one": _one_process(train, "cam", cfg("one", checkpointing_steps=2), max_steps=4,
                                device="cpu")}
    runs["stopped"] = ranks.run("tests._torch_mesh:run_train",
                                cfg("stopped", mesh={"fsdp": 2}, checkpointing_steps=100), 4,
                                (1, 2))
    runs["one_from_fsdp"] = _one_process(
        train, "cam", cfg("one_from_fsdp", checkpointing_steps=2,
                          resume_from=step2(runs["stopped"][0])), max_steps=4, device="cpu")
    runs["fsdp_from_one"] = ranks.run(
        "tests._torch_mesh:run_train",
        cfg("fsdp_from_one", mesh={"fsdp": 2}, checkpointing_steps=2,
            resume_from=step2(runs["one"])), 4)
    runs["lr"] = float(cfg("x")["learning_rate"])
    return runs


def _native(run: dict, step: int) -> dict:
    return ckpt.restore_native(os.path.join(run["run_dir"], "checkpoints", f"step-{step}"))


# The trainer runs in fp32: after an update the two layouts' clip norms differ
# in their last bits, and a tensor whose gradient is near zero throughout (the
# pose encoder's attention at ~2e-8) then moves by up to ~1.3e-5 of its own
# largest moment within two more steps; the float64 runs above hold 1e-5.
STATE_REL = 1e-4


def _state_close(got: dict, want: dict, lr: float):
    """Two state.pt records: the counts equal, the masters within 2 lr, the
    moments within STATE_REL of each tensor's largest magnitude plus 1e-3
    relative (``_close``'s form)."""
    assert (got["step"], got["epoch"], got["count"]) == (want["step"], want["epoch"],
                                                         want["count"])
    for key in ("masters", "exp_avg", "exp_avg_sq"):
        assert got[key].keys() == want[key].keys()
        for n, w in want[key].items():
            assert got[key][n].shape == w.shape, (key, n)
    for n, w in want["masters"].items():
        np.testing.assert_allclose(got["masters"][n].numpy(), w.numpy(), atol=2 * lr, rtol=0,
                                   err_msg=n)
    for key in ("exp_avg", "exp_avg_sq"):
        _close({n: v.numpy() for n, v in got[key].items()},
               {n: v.numpy() for n, v in want[key].items()}, rel=STATE_REL)


def test_sigterm_under_fsdp_stops_both_with_one_gather(fsdp_trainer_runs):
    """A SIGTERM on rank 1: both ranks stop at step 2 and assemble the final
    checkpoint together, once."""
    stopped = fsdp_trainer_runs["stopped"]
    assert [r["steps"] for r in stopped] == [2, 2]
    assert all(r["preempted"] for r in stopped)
    assert [r["assembled"] for r in stopped] == [[2], [2]]
    assert stopped[0]["checksums"] == stopped[1]["checksums"]


def test_fsdp_checkpoint_matches_one_process(fsdp_trainer_runs):
    """The state.pt assembled from the shards (the final save at step 2, the
    periodic one at step 4 after a resume) holds the whole tensors a
    one-process run holds, within the step's limits, and the split tensors'
    masters and moments are at most 0.55 of the whole bytes on a rank."""
    runs, lr = fsdp_trainer_runs, fsdp_trainer_runs["lr"]
    _state_close(_native(runs["stopped"][0], 2), _native(runs["one"], 2), lr)
    _state_close(_native(runs["fsdp_from_one"][0], 4), _native(runs["one"], 4), lr)
    whole = runs["one"]["state_bytes"]
    for r in runs["stopped"]:
        assert r["state_bytes"] <= 0.55 * whole, (r["state_bytes"], whole)


@pytest.mark.parametrize("run", ["one_from_fsdp", "fsdp_from_one"])
def test_fsdp_checkpoints_resume_across_layouts(fsdp_trainer_runs, run):
    """A checkpoint written under fsdp resumes in one process, and one
    written in one process resumes under fsdp, with the losses of the
    uninterrupted one-process run."""
    want = fsdp_trainer_runs["one"]["losses"][2:]
    outs = fsdp_trainer_runs[run]
    for r in outs if isinstance(outs, list) else [outs]:
        assert r["steps"] == 4
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5)


def _steps(case, mesh, accum=1, runner=None):
    args = (case["cfg"], case["states"], CFG, case["batches"], case["draws"], mesh, LR,
            "float64", accum)
    if runner is None:
        return _torch_mesh.cam_steps(*args)
    return runner.run("tests._torch_mesh:cam_steps", *args)


@pytest.fixture(scope="module")
def single(case):
    """The port's single-process steps (float64), one update a batch and one
    accumulating update of both."""
    return {1: _steps(case, {}), 2: _steps(case, {}, accum=2)}


def _close(got: dict, want: dict, rel: float = 1e-5):
    assert got.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, atol=rel * np.abs(w).max(), rtol=1e-3, err_msg=n)


def _masters_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, atol=2 * LR, rtol=0, err_msg=n)


@pytest.fixture(scope="module")
def mesh_runs(case, ranks):
    return {axis: _steps(case, sizes, runner=ranks) for axis, sizes in MESHES.items()}


@pytest.fixture(scope="module")
def mesh_runs4(case):
    pool = RankPool(4)
    try:
        return {axis: _steps(case, sizes, runner=pool) for axis, sizes in MESHES4.items()}
    finally:
        pool.close()


def _mesh_run(request, axis):
    return request.getfixturevalue("mesh_runs4" if axis in MESHES4 else "mesh_runs")[axis]


@pytest.mark.parametrize("axis", [*MESHES, *MESHES4])
def test_mesh_step_matches_single_process(request, single, axis):
    """A 2-rank (4-rank) step equals a 1-process step on the concatenated
    batch with the same draws: loss and gradients (averaged over the ranks,
    before the clip), and the masters after each of 2 AdamW steps; the
    replicas equal bit for bit."""
    outs = _mesh_run(request, axis)
    for o in outs[1:]:
        assert o["checksums"] == outs[0]["checksums"]
        for a, b in zip(o["masters"], outs[0]["masters"]):
            assert all(np.array_equal(a[n], b[n]) for n in a)
    got, want = outs[0], single[1]
    for k in want["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
    _close(got["grads"], want["grads"])
    for a, b in zip(got["masters"], want["masters"]):
        _masters_close(a, b)


def _accumulation(case, ranks, single, axis):
    outs = _steps(case, MESHES[axis], accum=2, runner=ranks)
    assert outs[0]["checksums"] == outs[1]["checksums"]
    assert outs[0]["working"] == outs[1]["working"]
    assert len(outs[0]["masters"]) == 1
    _masters_close(outs[0]["masters"][0], single[2]["masters"][0])
    np.testing.assert_allclose(outs[0]["losses"], single[2]["losses"], rtol=1e-5)


def test_accumulation_on_the_data_axis(case, ranks, single):
    """Two micro-batches a step on data = 2: the gradients summed over the
    micro-batches, averaged over the ranks once, one update."""
    _accumulation(case, ranks, single, "data")


def test_accumulation_on_the_fsdp_axis(case, ranks, single):
    """The same on fsdp = 2: the summed gradients reduce-scattered once, one
    update of each rank's rows, one gather."""
    _accumulation(case, ranks, single, "fsdp")


@pytest.mark.parametrize("axis", [*MESHES, *MESHES4])
def test_replicas_hold_equal_working_weights(request, axis):
    """Every rank's working weights (the model's tensors) are equal bit for
    bit after every step: under fsdp they come out of one all-gather."""
    outs = _mesh_run(request, axis)
    assert all(o["working"] == outs[0]["working"] for o in outs[1:])


def test_fsdp_ranks_hold_their_rows_of_masters_and_moments(mesh_runs):
    """Under fsdp = 2 each rank's masters and AdamW moments are its dim-0
    chunks of the split tensors (the whole ones for the others), which take
    at most 0.55 of the whole set's bytes; the zero moments before the first
    update gather to the whole shapes."""
    outs = mesh_runs["fsdp"]
    masters = outs[0]["masters"][-1]
    whole_bytes = 3 * sum(m.size * 4 for m in masters.values())
    split = [n for n, r in outs[0]["own"]["rows"].items() if r is not None]
    assert split, "no tensor split"
    for r, o in enumerate(outs):
        own = o["own"]
        assert own["bytes"] <= 0.55 * whole_bytes, (own["bytes"], whole_bytes)
        for n, rows in own["rows"].items():
            want = slice(None) if rows is None else slice(*rows)
            if rows is not None:
                k = masters[n].shape[0] // 2
                assert rows == (r * k, (r + 1) * k), n
            assert np.array_equal(own["masters"][n], masters[n][want]), n
            for key in ("exp_avg", "exp_avg_sq"):
                assert np.array_equal(own[key][n], o["moments"][key][n][want]), (key, n)
        assert o["moments"]["exp_avg"].keys() == masters.keys()
        # a checkpoint before the first update gathers the whole shapes too
        assert o["moments_before"] == {n: m.shape for n, m in masters.items()}


def test_a_mesh_that_does_not_fit_the_world_raises(ranks):
    msgs = ranks.run("tests._torch_mesh:mesh_error", {"data": 3})
    assert all("2 ranks cannot form a data=3 mesh" in m for m in msgs), msgs


def test_an_fsdp_mesh_that_does_not_fit_the_world_raises(ranks):
    msgs = ranks.run("tests._torch_mesh:mesh_error", {"data": 1, "fsdp": 3, "sp": 1})
    assert all("2 ranks cannot form a data=1 x fsdp=3 x sp=1 mesh (3 ranks)" in m
               for m in msgs), msgs


def test_mesh_without_a_process_group_raises(tmp_path):
    cfg = dict(_config(), output_dir=str(tmp_path), mesh={"data": 2})
    with pytest.raises(RuntimeError, match="needs a process group.*torch.distributed.run"):
        train("cam", cfg, iter([]), 1, device="cpu")


@pytest.mark.parametrize("axis", [*MESHES, *MESHES4])
def test_mesh_grads_match_jax(request, case, axis):
    """The mesh's averaged gradients and loss against the JAX package's grads
    function on the concatenated batch (test_torch_train.py's tolerances)."""
    got = _mesh_run(request, axis)[0]
    jgrads, jmetrics = case["jax"].result()
    for k in ("loss", "sd_loss", "mask_loss"):
        np.testing.assert_allclose(got["metrics"][k], jmetrics[k], rtol=1e-5, err_msg=k)
    assert set(got["grads"]) == set(jgrads)
    for n, g in got["grads"].items():
        w = jgrads[n]
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=1e-3, err_msg=n)
