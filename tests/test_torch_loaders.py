"""The port's checkpoint readers against the JAX package's, on files the JAX
package writes, and the default start of the port's build_pipeline.

Tiny obj-stage widths (UNet 32/64/128/128, 4 heads), fp32.  The JAX package
writes an SD1.5 diffusers directory (``export_torch_state``: the UNet's
spatial keys as F32 safetensors, the VAE as F16 safetensors, the text
encoder as ``.bin``, a BPE tokenizer), an AnimateDiff-layout motion-module
``state_dict`` file and its stage-1/2/3 bundles; both packages'
``load_pretrained`` read them and every weight must agree exactly.  The
safetensors reader is held to the ``safetensors`` package.  No JAX sampler
is compiled: the one JAX program is a UNet forward at XLA backend level 0.
"""

import copy
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import Scope
from flax.traverse_util import flatten_dict, unflatten_dict

from synfmc_tpu.config import load_config as jax_load_config
from synfmc_tpu.interop.sd_loader import load_sd15 as jax_load_sd15
from synfmc_tpu.interop.torch_port import export_torch_state, unet_path_to_torch
from synfmc_tpu.training import checkpoint as jckpt
from synfmc_tpu.training.trainers import build_models as jax_build_models
from synfmc_tpu.training.trainers import load_pretrained as jax_load_pretrained
from synfmc_tpu.training.trainers import validate_pretrained_paths as jax_validate
from synfmc_tpu_torch.data.tokenizer import CLIPTokenizer
from synfmc_tpu_torch.interop.safetensors import SafetensorsError, load_file
from synfmc_tpu_torch.interop.sd_loader import load_sd15
from synfmc_tpu_torch.interop.torch_port import jax_state_dict
from synfmc_tpu_torch.pipelines.factory import _STRUCTURAL_ZEROS, build_models, build_pipeline
from synfmc_tpu_torch.training.pretrained import load_pretrained, validate_pretrained_paths
from tests.test_torch_modules import randomize, shapes
from tests.test_torch_slice import TINY
from tests.test_torch_tokenizer import write_bpe_vocab

from safetensors.numpy import save_file as np_save_file  # noqa: E402  (reference writer)
from safetensors.torch import load_file as st_load_file  # noqa: E402
from safetensors.torch import save_file as st_save_file  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, W = 2, 64, 64
KINDS = {"unet": "unet", "vae": "vae", "text": "clip_text", "pose_encoder": "pose_encoder",
         "adapter": "adapter"}
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
PLACEHOLDERS = ("pretrained_model_path", "lora_ckpt", "pretrained_cm_path", "motion_module_ckpt")


def tiny_obj_config():
    cfg = jax_load_config(os.path.join(REPO, "configs", "obj.yaml"))
    cfg["model_overrides"] = copy.deepcopy(TINY)
    cfg["unet_additional_kwargs"]["motion_module_kwargs"]["num_attention_heads"] = 4
    cfg["pose_encoder_kwargs"]["temporal_attention_nhead"] = 4
    cfg["mixed_precision_training"] = False
    return cfg


def init_args(kind, chs):
    """Init arguments of each JAX module (shapes only matter)."""
    pose = [jnp.zeros((1, F, H // 8 // 2**i, W // 8 // 2**i, c)) for i, c in enumerate(chs)]
    return {
        "unet": ((jnp.zeros((1, F, H // 8, W // 8, 4)), jnp.zeros((1,), jnp.int32),
                  jnp.zeros((1, 77, 64))), {"pose_features": pose}),
        "vae": ((jnp.zeros((1, 32, 32, 3)),), {}),
        "text": ((jnp.zeros((1, 77), jnp.int32),), {}),
        "pose_encoder": ((jnp.zeros((1, F, H, W, 6)),), {}),
        "adapter": ((jnp.zeros((F, H, W, 13)), jnp.zeros((F, H, W, 1))), {}),
    }[kind]


def trace_inits(models) -> tuple[dict, set]:
    """Each JAX module's param shapes, and the torch names of the UNet leaves
    whose JAX initializer is zeros: ``module.init`` is traced (not run) with
    the initializers it asks for recorded."""
    chs = TINY["block_out_channels"]
    seen, trees = [], {}
    orig = Scope.param

    def param(self, name, init_fn, *a, **k):
        seen.append((tuple(self.path) + (name,), init_fn))
        return orig(self, name, init_fn, *a, **k)

    for kind, module in sorted(models.items()):
        args, kw = init_args(kind, chs)
        Scope.param = param if kind == "unet" else orig
        try:
            trees[kind] = shapes(module, jax.random.PRNGKey(0), *args, **kw)
        finally:
            Scope.param = orig
    zeros = {unet_path_to_torch(path) for path, fn in seen if fn is jax.nn.initializers.zeros}
    return trees, zeros


def jax_params(shape_trees, seed):
    """Seeded random values for every leaf of every JAX module (no compile)."""
    return {kind: randomize(tree, seed=seed + i)["params"]
            for i, (kind, tree) in enumerate(sorted(shape_trees.items()))}


def subtree(tree, pred):
    return unflatten_dict({k: v for k, v in flatten_dict(tree).items() if pred("/".join(k))})


def contiguous(sd):
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX models, the source weights, and every file in the reference
    layout, written by the JAX package."""
    root = tmp_path_factory.mktemp("ckpts")
    cfg = tiny_obj_config()
    models = jax_build_models(cfg, "obj")
    shape_trees, zeros = trace_inits(models)
    src = jax_params(shape_trees, seed=1)
    sd_dir = root / "sd"
    unet = export_torch_state(src["unet"], "unet")
    spatial = {k: v for k, v in unet.items() if "motion_modules" not in k and ".processor." not in k}
    os.makedirs(sd_dir / "unet")
    np_save_file(contiguous(spatial), str(sd_dir / "unet" / "diffusion_pytorch_model.safetensors"))
    os.makedirs(sd_dir / "vae")
    vae = {k: v.astype(np.float16) for k, v in export_torch_state(src["vae"], "vae").items()}
    np_save_file(contiguous(vae), str(sd_dir / "vae" / "diffusion_pytorch_model.safetensors"),
                 metadata={"format": "pt"})
    os.makedirs(sd_dir / "text_encoder")
    text = {k: torch.from_numpy(np.array(v))
            for k, v in export_torch_state(src["text"], "clip_text").items()}
    text["text_model.embeddings.position_ids"] = torch.arange(77)[None]  # ignorable
    torch.save(text, str(sd_dir / "text_encoder" / "pytorch_model.bin"))
    write_bpe_vocab(str(sd_dir / "tokenizer"))

    motion = {k: torch.from_numpy(np.array(v)) for k, v in unet.items()
              if "motion_modules" in k and ".processor." not in k}
    for k in list(motion):  # AnimateDiff's PE tables: dropped by both readers
        if k.endswith("attention_blocks.0.to_q.weight") or k.endswith("attention_blocks.1.to_q.weight"):
            motion[k.replace("to_q.weight", "pos_encoder.pe")] = torch.zeros(1, 32, motion[k].shape[1])
    torch.save({"state_dict": motion}, str(root / "mm.ckpt"))
    jckpt.save_stage1_bundle(str(root / "lora.ckpt"), subtree(src["unet"], lambda p: "lora" in p),
                             epoch=1, global_step=10)
    jckpt.save_stage2_bundle(str(root / "cmc.ckpt"), src["pose_encoder"],
                             subtree(src["unet"], lambda p: "merge" in p), epoch=2, global_step=20,
                             mm_params=subtree(src["unet"], lambda p: "motion_modules" in p
                                               and p.endswith("proj_in/kernel")))
    omcm = jckpt.save_stage3_bundles(str(root), 30, omcm_params=src["adapter"])[0]

    # broken variants for the failure cases
    extra = dict(motion)
    extra["down_blocks.0.motion_modules.0.temporal_transformer.bogus.weight"] = torch.zeros(3)
    torch.save({"state_dict": extra}, str(root / "mm_extra.ckpt"))
    bundle = torch.load(str(root / "lora.ckpt"), weights_only=False)
    first = sorted(bundle["lora_state_dict"])[0]
    bundle["lora_state_dict"][first] = torch.zeros(3, 3)
    torch.save(bundle, str(root / "lora_shape.ckpt"))

    files = dict(pretrained_model_path=str(sd_dir), motion_module_ckpt=str(root / "mm.ckpt"),
                 lora_ckpt=str(root / "lora.ckpt"), pretrained_cm_path=str(root / "cmc.ckpt"),
                 omcm=omcm, root=str(root))
    # what the files hold: the VAE went through float16
    written = dict(src, vae=jax.tree_util.tree_map(
        lambda v: np.asarray(v).astype(np.float16).astype(np.float32), src["vae"]))
    return dict(cfg=cfg, models=models, written=written, files=files, zeros=zeros,
                shape_trees=shape_trees, template=jax_params(shape_trees, seed=2))


def config_with(ref, **paths):
    """The tiny obj config with the given checkpoint paths (others left as
    the shipped placeholders)."""
    cfg = copy.deepcopy(ref["cfg"])
    for key, val in paths.items():
        if key == "omcm":
            cfg["omcm_config"]["pretrained"] = val
        else:
            cfg[key] = val
    return cfg


def port_models(cfg):
    models = build_models(cfg, "obj")
    gen = torch.Generator().manual_seed(7)
    for m in models.values():
        for p in m.parameters():
            p.data.copy_(torch.randn(p.shape, generator=gen))
    return models


def assert_same_weights(jax_tree, module, kind):
    want = jax_state_dict(jax_tree, kind)
    got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    assert set(got) == set(want), (set(got) ^ set(want))
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, f"{kind}: {len(bad)} tensors differ, e.g. {bad[:3]}"


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

ALL_DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
              torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool]


def test_safetensors_reader_matches_the_package(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {}
    for dt in ALL_DTYPES:
        name = str(dt).split(".")[-1]
        base = torch.randn(3, 5, generator=gen) * 50
        tensors[name] = base > 0 if dt == torch.bool else base.to(dt)
        tensors[name + "_scalar"] = base[0, 0].to(dt).clone()
        tensors[name + "_empty"] = torch.zeros(0, 4, dtype=dt)
    path = str(tmp_path / "all.safetensors")
    st_save_file(tensors, path, metadata={"format": "pt", "note": "every dtype"})
    got, want = load_file(path), st_load_file(path)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def _raw_file(path, header: bytes, data: bytes, n=None):
    with open(path, "wb") as fh:
        fh.write((len(header) if n is None else n).to_bytes(8, "little") + header + data)


@pytest.mark.parametrize("header,data,n,match", [
    (b'{"a":{"dtype":"F32","shape":[2],"data_offsets":[0,8]}}', b"\0" * 4, None, "outside"),
    (b'{"a":{"dtype":"F32","shape":[3],"data_offsets":[0,8]}}', b"\0" * 8, None, "want 12"),
    (b'{"a":{"dtype":"Q4","shape":[2],"data_offsets":[0,8]}}', b"\0" * 8, None, "dtype"),
    (b'{"a":{"dtype":"U8","shape":[2],"data_offsets":[0,2]},'
     b'"b":{"dtype":"U8","shape":[2],"data_offsets":[1,3]}}', b"\0" * 3, None, "overlapping"),
    (b'{"a":{"dtype":"U8","shape":[2],"data_offsets":[0,2]}}', b"\0" * 4, None, "cover"),
    (b'{"a":', b"", None, "not JSON"),
    (b"{}", b"", 1 << 40, "does not fit"),
], ids=["past_end", "byte_count", "dtype", "overlap", "hole", "json", "header_length"])
def test_safetensors_reader_rejects_malformed_files(tmp_path, header, data, n, match):
    path = str(tmp_path / "bad.safetensors")
    _raw_file(path, header, data, n)
    with pytest.raises(SafetensorsError, match=match):
        load_file(path)


# ---------------------------------------------------------------------------
# the readers against the JAX package's
# ---------------------------------------------------------------------------


def test_load_sd15_matches_jax(ref):
    template = ref["template"]
    want = jax_load_sd15({k: template[k] for k in ("unet", "vae", "text")},
                         ref["files"]["pretrained_model_path"])
    models = port_models(ref["cfg"])
    load_sd15(models, ref["files"]["pretrained_model_path"])
    for kind in ("vae", "text"):
        assert_same_weights(want[kind], models[kind], KINDS[kind])
    # the UNet: SD1.5's keys loaded, the rest (motion modules, merges, LoRA) kept
    sd = export_torch_state(want["unet"], "unet")
    got = models["unet"].state_dict()
    spatial = [k for k in sd if "motion_modules" not in k and ".processor." not in k]
    assert all(np.array_equal(got[k].numpy(), sd[k]) for k in spatial)
    kept = [k for k in got if k not in spatial]
    assert kept and not any(np.array_equal(got[k].numpy(), sd[k]) for k in kept)


def test_load_pretrained_matches_jax_bit_for_bit(ref):
    """SD1.5 + motion modules + LoRA + CMC + OMC: every weight of every module
    equals the JAX package's load and the written source."""
    files = ref["files"]
    cfg = config_with(ref, **{k: files[k] for k in PLACEHOLDERS}, omcm=files["omcm"])
    log = logging.getLogger("test_loaders")
    want, want_meta = jax_load_pretrained(dict(ref["template"]), cfg, "obj", log)
    models, meta = load_pretrained(port_models(cfg), cfg, "obj", log)
    assert meta == want_meta == {"omcm_global_step": 30}
    for key, kind in KINDS.items():
        assert_same_weights(want[key], models[key], kind)
        assert_same_weights(ref["written"][key], models[key], kind)


def _run(fn):
    """(exception type or None, ERROR messages) of ``fn(logger)``."""
    records = []
    log = logging.getLogger(f"test_loaders.{len(records)}")
    log.handlers, log.propagate = [], False
    handler = logging.Handler()
    handler.emit = records.append
    log.addHandler(handler)
    try:
        fn(log)
        raised = None
    except Exception as e:  # the outcome is compared
        raised = type(e)
    return raised, [r.getMessage() for r in records if r.levelno >= logging.ERROR]


@pytest.mark.parametrize("case,want_raise,want_errors", [
    ("unconsumed", AssertionError, 0),
    ("shape_mismatch", ValueError, 0),
    ("placeholder", None, 0),
    ("missing", None, 1),
    ("missing_strict", FileNotFoundError, 0),
    ("missing_omcm", None, 1),
])
def test_loader_failures_match_jax(ref, case, want_raise, want_errors):
    files = ref["files"]
    paths = {
        "unconsumed": dict(motion_module_ckpt=os.path.join(files["root"], "mm_extra.ckpt")),
        "shape_mismatch": dict(lora_ckpt=os.path.join(files["root"], "lora_shape.ckpt")),
        "placeholder": dict(lora_ckpt="[path to stage-1 lora ckpt]"),
        "missing": dict(lora_ckpt=os.path.join(files["root"], "no_such.ckpt")),
        "missing_strict": dict(lora_ckpt=os.path.join(files["root"], "no_such.ckpt"),
                               strict_pretrained=True),
        "missing_omcm": dict(omcm=os.path.join(files["root"], "no_such_omcm.ckpt")),
    }[case]
    cfg = config_with(ref, **paths)
    got = _run(lambda log: load_pretrained(port_models(cfg), cfg, "obj", log))
    want = _run(lambda log: jax_load_pretrained(dict(ref["template"]), cfg, "obj", log))
    assert got[0] is want[0] is want_raise
    assert len(got[1]) == len(want[1]) == want_errors
    assert all("does not exist" in m for m in got[1] + want[1])


@pytest.mark.parametrize("stage,cm,allow,raises", [
    ("obj", False, False, True), ("obj", False, True, False), ("obj", True, False, False),
    ("cam", False, False, False),
])
def test_untrained_cm_rule_matches_jax(ref, stage, cm, allow, raises):
    cfg = config_with(ref, **({"pretrained_cm_path": ref["files"]["pretrained_cm_path"]}
                              if cm else {}))
    if allow:
        cfg["allow_untrained_cm"] = True
    for fn in (validate_pretrained_paths, jax_validate):
        if raises:
            with pytest.raises(FileNotFoundError, match="requires a trained stage-2 CMC"):
                fn(cfg, stage)
        else:
            fn(cfg, stage)
    if raises:  # build_pipeline checks before building anything
        with pytest.raises(FileNotFoundError, match="requires a trained stage-2 CMC"):
            build_pipeline(cfg, stage=stage, device="cpu")


def test_build_pipeline_loads_every_file(ref):
    files = ref["files"]
    cfg = config_with(ref, **{k: files[k] for k in PLACEHOLDERS if k != "pretrained_cm_path"})
    pipe, info = build_pipeline(cfg, cm_ckpt=files["pretrained_cm_path"],
                                omcm_ckpt=files["omcm"], device="cpu")
    assert info["stage"] == "obj" and info["sample_size"] == (256, 384)
    assert set(info) >= {"stage", "sample_size", "models", "schedule"}
    assert isinstance(pipe.tokenizer, CLIPTokenizer)
    for key, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text", pipe.text_encoder),
                        ("pose_encoder", pipe.pose_encoder), ("adapter", pipe.adapter)):
        assert_same_weights(ref["written"][key], module, KINDS[key])
    with pytest.raises(RuntimeError, match="mesh needs a process group"):
        build_pipeline(cfg, data_parallel=2, device="cpu")


# ---------------------------------------------------------------------------
# build_pipeline's default start: the JAX package's structural zeros
# ---------------------------------------------------------------------------


def test_default_start_matches_jax_after_a_partial_load(ref):
    """SD1.5 without a LoRA bundle: the port's UNet, built and loaded from the
    same directory, with the JAX build's other weights carried across, gives
    the JAX UNet's output.  The port's structural groups keep their own
    start, which must be the JAX package's zeros: random LoRA up-projections
    and pose merges (the parent's start) change the output."""
    cfg = config_with(ref, pretrained_model_path=ref["files"]["pretrained_model_path"])
    unet_j, zeros = ref["models"]["unet"], ref["zeros"]
    flat = flatten_dict(jax_params({"unet": ref["shape_trees"]["unet"]}, seed=5)["unet"])
    flat = {k: (np.zeros_like(v) if unet_path_to_torch(k) in zeros else v) for k, v in flat.items()}
    params_j = jax_load_sd15({"unet": unflatten_dict(flat)},
                             ref["files"]["pretrained_model_path"])["unet"]

    pipe, _ = build_pipeline(cfg, stage="cam", device="cpu", seed=3)
    structural = {n for n, p in pipe.unet.named_parameters() if _STRUCTURAL_ZEROS.search(n)}
    assert structural and structural == {n for n in zeros
                                         if pipe.unet.get_parameter(n).dim() > 1
                                         or "_merge." in n}
    carried = {k: torch.from_numpy(v) for k, v in jax_state_dict(params_j, "unet").items()
               if k not in zeros}
    missing, unexpected = pipe.unet.load_state_dict(carried, strict=False)
    assert not unexpected and set(missing) == zeros

    rng = np.random.default_rng(11)
    chs = TINY["block_out_channels"]
    x = rng.normal(size=(2, F, H // 8, W // 8, 4)).astype(np.float32)
    t = np.array([500, 500], np.int32)
    ctx = rng.normal(size=(2, 77, 64)).astype(np.float32)
    pose = [rng.normal(size=(2, F, H // 8 // 2**i, W // 8 // 2**i, c)).astype(np.float32)
            for i, c in enumerate(chs)]
    fn = jax.jit(lambda p, x, t, c, pf: unet_j.apply({"params": p}, x, t, c, pose_features=pf))
    jargs = (params_j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
             [jnp.asarray(p) for p in pose])
    want = np.asarray(fn.lower(*jargs).compile(compiler_options=FAST)(*jargs))
    with torch.no_grad():
        got = pipe.unet(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                        pose_features=[torch.from_numpy(p) for p in pose]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
