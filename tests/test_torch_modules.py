"""The port's modules against the JAX package's, with carried weights.

Every JAX module is initialised, its parameters are replaced by seeded
random values (so zero-initialised LoRA and pose-merge branches count too),
and the same tree is loaded into the port with
``load_jax_params(..., strict=True)``.  Inputs come from numpy; both sides
run in fp32 on the CPU.  Tolerances are those of
tests/test_fullstack_parity.py (atol 1e-4, rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from synfmc_tpu.interop.torch_port import export_torch_state
from synfmc_tpu.models import attention as jattn
from synfmc_tpu.models import layers as jlayers
from synfmc_tpu.models.clip_text import CLIPTextModel as JCLIP
from synfmc_tpu.models.motion_module import TemporalTransformer3D as JTemporal
from synfmc_tpu.models.pose_encoder import CameraPoseEncoder as JPose
from synfmc_tpu.models.unet3d import UNet3D as JUNet
from synfmc_tpu.models.vae import AutoencoderKL as JVAE
from synfmc_tpu.geometry.plucker import plucker_embedding as jax_plucker
from synfmc_tpu_torch.geometry.plucker import plucker_embedding
from synfmc_tpu_torch.interop.torch_port import jax_state_dict, load_jax_params
from synfmc_tpu_torch.models import attention as tattn
from synfmc_tpu_torch.models import layers as tlayers
from synfmc_tpu_torch.models.clip_text import CLIPTextModel
from synfmc_tpu_torch.models.motion_module import VanillaTemporalModule
from synfmc_tpu_torch.models.pose_encoder import CameraPoseEncoder
from synfmc_tpu_torch.models.unet3d import UNet3D
from synfmc_tpu_torch.models.vae import AutoencoderKL
from synfmc_tpu_torch.ops.pixel import pixel_unshuffle

TOL = dict(atol=1e-4, rtol=1e-3)
CHS = (32, 64, 128, 128)


def randomize(params, seed=0):
    """Seeded random values for every leaf of a JAX param tree."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        name = str(path[-1].key)
        shape = np.shape(leaf)
        if name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "bias":
            v = 0.1 * rng.normal(size=shape)
        elif name == "embedding":
            v = rng.normal(size=shape)
        else:
            v = 0.01 * rng.normal(size=shape)
        out.append(jnp.asarray(v, jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def shapes(module, *args, **kwargs):
    """The param tree's shapes, without running the init."""
    return jax.eval_shape(module.init, *args, **kwargs)


def japply(jm, params, *args, method=None, **kwargs):
    """jm.apply under one jit: far faster on the CPU than op-by-op dispatch."""
    fn = jax.jit(lambda p, a, k: jm.apply(p, *a, method=method, **k))
    out = fn(params, args, kwargs)
    return jax.tree_util.tree_map(np.asarray, out)


def nest(path: str, module: nn.Module) -> nn.Module:
    """Place ``module`` at a dotted path ('attentions.0.attn1') of a holder."""
    for part in reversed(path.split(".")):
        if part.isdigit():
            assert part == "0"
            module = nn.ModuleList([module])
        else:
            module = nn.ModuleDict({part: module})
    return module


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def check(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_timestep_and_positional_tables():
    ts = np.array([0, 1, 321, 999])
    check(tlayers.timestep_embedding(torch.from_numpy(ts), 320),
          jlayers.timestep_embedding(jnp.asarray(ts), 320))
    check(tlayers.sinusoidal_positional_encoding(32, 64),
          jlayers.sinusoidal_positional_encoding(32, 64))


@pytest.mark.parametrize("cin,cout", [(64, 64), (32, 64)])
def test_resnet_block(rng, cin, cout):
    x = rng.normal(size=(2, 8, 12, cin)).astype(np.float32)
    temb = rng.normal(size=(2, 128)).astype(np.float32)
    jm = jlayers.ResnetBlock2D(out_channels=cout)
    params = randomize(shapes(jm, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(temb)))
    want = japply(jm, params, jnp.asarray(x), jnp.asarray(temb))
    tm = tlayers.ResnetBlock2D(cin, cout, 128)
    load_jax_params(nest("resnets.0", tm), {"resnets_0": params["params"]}, "unet")
    check(tm(t(x), t(temb)), want)


def test_down_up_sample_feedforward(rng):
    x = rng.normal(size=(2, 8, 12, 32)).astype(np.float32)
    for jm, tm, path in [
        (jlayers.Downsample2D(32), tlayers.Downsample2D(32, 32), "downsamplers.0"),
        (jlayers.Upsample2D(32), tlayers.Upsample2D(32, 32), "upsamplers.0"),
    ]:
        params = randomize(shapes(jm, jax.random.PRNGKey(1), jnp.asarray(x)))
        load_jax_params(nest(path, tm), {path.replace(".", "_"): params["params"]}, "unet")
        check(tm(t(x)), japply(jm, params, jnp.asarray(x)))
    jff = jlayers.FeedForward()
    params = randomize(shapes(jff, jax.random.PRNGKey(2), jnp.asarray(x)))
    tff = tlayers.FeedForward(32)
    load_jax_params(nest("ff", tff), {"ff": params["params"]}, "unet")
    check(tff(t(x)), japply(jff, params, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pose_cond,cross", [("none", True), ("qkv", False), ("q", True),
                                             ("kv", False)])
def test_attention_variants(rng, pose_cond, cross):
    b, s, dim, xdim = 3, 16, 32, 24
    x = rng.normal(size=(b, s, dim)).astype(np.float32)
    ctx = rng.normal(size=(b, 7, xdim)).astype(np.float32) if cross else None
    kv_dim = xdim if cross else dim
    pose = rng.normal(size=(b, 7 if pose_cond == "kv" and cross else s,
                            kv_dim if pose_cond == "kv" else dim)).astype(np.float32)
    kw = dict(heads=4, dim_head=8, lora_rank=4, pose_cond=pose_cond, pose_scale=0.5,
              temporal_pe_max_len=0 if cross else 32)
    jm = jattn.Attention(cross_attention_dim=xdim if cross else None, **kw)
    jargs = (jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), jnp.asarray(pose))
    params = randomize(shapes(jm, jax.random.PRNGKey(3), *jargs))
    want = japply(jm, params, *jargs)
    tm = tattn.Attention(dim, cross_attention_dim=xdim if cross else None, **kw)
    load_jax_params(nest("attentions.0.transformer_blocks.0.attn1", tm),
                    {"attentions_0": {"blocks_0": {"attn1": params["params"]}}}, "unet")
    check(tm(t(x), None if ctx is None else t(ctx), t(pose)), want)


def test_spatial_transformer_with_lora(rng):
    x = rng.normal(size=(4, 8, 12, 64)).astype(np.float32)
    ctx = rng.normal(size=(4, 77, 48)).astype(np.float32)
    jm = jattn.SpatialTransformer(heads=4, dim_head=16, cross_attention_dim=48, lora_rank=8)
    params = randomize(shapes(jm, jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(ctx)))
    tm = tattn.SpatialTransformer(64, 4, 16, cross_attention_dim=48, lora_rank=8)
    load_jax_params(nest("attentions.0", tm), {"attentions_0": params["params"]}, "unet")
    check(tm(t(x), t(ctx)), japply(jm, params, jnp.asarray(x), jnp.asarray(ctx)))


def test_motion_module_with_pose(rng):
    b, f, h, w, c = 1, 16, 4, 6, 64
    x = rng.normal(size=(b, f, h, w, c)).astype(np.float32)
    pose = rng.normal(size=(b, f, h, w, c)).astype(np.float32) * 0.3
    jm = JTemporal(num_attention_heads=8, pose_cond_blocks=(0,), pose_scale=0.5)
    params = randomize(shapes(jm, jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(pose)))
    tm = VanillaTemporalModule(c, num_attention_heads=8, pose_cond_blocks=(0,), pose_scale=0.5)
    load_jax_params(nest("motion_modules.0", tm), {"motion_modules_0": params["params"]}, "unet")
    check(tm(t(x), t(pose)), japply(jm, params, jnp.asarray(x), jnp.asarray(pose)))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def unet_kwargs():
    return dict(block_out_channels=CHS, attn_heads=4, cross_attention_dim=48,
                use_motion_module=True, motion_num_heads=4, camera_cond=True,
                pose_scale=0.5, lora_rank=8)


@pytest.fixture(scope="module")
def unet_case():
    rng = np.random.default_rng(11)
    b, f, h, w = 1, 2, 16, 24
    x = rng.normal(size=(b, f, h, w, 4)).astype(np.float32)
    ctx = rng.normal(size=(b, 7, 48)).astype(np.float32)
    pose = [rng.normal(size=(b, f, h // 2**i, w // 2**i, c)).astype(np.float32) * 0.3
            for i, c in enumerate(CHS)]
    traj = [rng.normal(size=(b, f, h // 2**i, w // 2**i, c)).astype(np.float32) * 0.3
            for i, c in enumerate(CHS)]
    jm = JUNet(**unet_kwargs())
    args = (jnp.asarray(x), jnp.asarray([321]), jnp.asarray(ctx))
    params = randomize(shapes(jm, jax.random.PRNGKey(6), *args,
                               pose_features=[jnp.asarray(p) for p in pose]))
    want = japply(jm, params, *args, pose_features=[jnp.asarray(p) for p in pose],
                    traj_features=[jnp.asarray(p) for p in traj])
    return params, (x, ctx, pose, traj), np.asarray(want)


def test_unet3d_matches_jax(unet_case):
    params, (x, ctx, pose, traj), want = unet_case
    tm = load_jax_params(UNet3D(**unet_kwargs()), params, "unet")
    with torch.no_grad():
        got = tm(t(x), torch.tensor([321]), t(ctx), pose_features=[t(p) for p in pose],
                 traj_features=[t(p) for p in traj])
        check(got, want)
        # the plain 4th down block never receives traj features
        traj2 = [t(p) for p in traj[:3]] + [t(traj[3]) + 10.0]
        got2 = tm(t(x), torch.tensor([321]), t(ctx), pose_features=[t(p) for p in pose],
                  traj_features=traj2)
    np.testing.assert_array_equal(got.numpy(), got2.numpy())


def test_pose_encoder_and_plucker_match_jax(rng):
    b, f, h, w = 1, 4, 64, 96
    intr = np.broadcast_to(np.array([w, h, 0, 0], np.float32), (b, f, 4)).copy()
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, f, 1, 1))
    c2w[..., :3, 3] = rng.normal(size=(b, f, 3))
    ang = rng.normal(size=(b, f)) * 0.3
    c2w[..., 0, 0] = c2w[..., 2, 2] = np.cos(ang)
    c2w[..., 0, 2], c2w[..., 2, 0] = np.sin(ang), -np.sin(ang)
    want_pl = np.asarray(jax_plucker(jnp.asarray(intr), jnp.asarray(c2w), h, w))
    pl = plucker_embedding(t(intr), t(c2w), h, w)
    np.testing.assert_allclose(pl.numpy(), want_pl, atol=1e-5, rtol=1e-5)
    check(pixel_unshuffle(pl.reshape(b * f, h, w, 6), 8),
          np.asarray(want_pl).reshape(b * f, h // 8, 8, w // 8, 8, 6)
          .transpose(0, 1, 3, 5, 2, 4).reshape(b * f, h // 8, w // 8, 384))

    jm = JPose(channels=CHS, temporal_attention_nhead=4)
    params = randomize(shapes(jm, jax.random.PRNGKey(7), jnp.asarray(want_pl)))
    want = japply(jm, params, jnp.asarray(want_pl))
    tm = load_jax_params(CameraPoseEncoder(channels=CHS, temporal_attention_nhead=4), params,
                         "pose_encoder")
    with torch.no_grad():
        got = tm(pl)
    assert len(got) == 4
    for g, wnt in zip(got, want):
        check(g, wnt)


def test_clip_text_matches_jax(rng):
    ids = rng.integers(0, 1000, size=(2, 77)).astype(np.int32)
    jm = JCLIP(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4)
    params = randomize(shapes(jm, jax.random.PRNGKey(8), jnp.asarray(ids)))
    tm = load_jax_params(CLIPTextModel(1000, 64, 2, 4), params, "clip_text")
    with torch.no_grad():
        check(tm(torch.from_numpy(ids)), japply(jm, params, jnp.asarray(ids)))


def test_vae_matches_jax(rng):
    chs = (32, 32, 64, 64)
    z = rng.normal(size=(2, 4, 6, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, size=(1, 32, 48, 3)).astype(np.float32)
    jm = JVAE(block_out_channels=chs)
    params = randomize(shapes(jm, jax.random.PRNGKey(9), jnp.asarray(x)))
    tm = load_jax_params(AutoencoderKL(chs), params, "vae")
    with torch.no_grad():
        check(tm.decode(t(z)), japply(jm, params, jnp.asarray(z), method=JVAE.decode))
        gm, gl = tm.encode_moments(t(x))
    wm, wl = japply(jm, params, jnp.asarray(x), method=JVAE.encode_moments)
    check(gm, wm)
    check(gl, wl)


# ---------------------------------------------------------------------------
# weights across
# ---------------------------------------------------------------------------


def _tiny_jax_params():
    f, h, w = 2, 64, 64
    unet = JUNet(**unet_kwargs())
    pose_feats = [jnp.zeros((1, f, h // 8 // 2**i, w // 8 // 2**i, c)) for i, c in enumerate(CHS)]
    return {
        "unet": shapes(unet, jax.random.PRNGKey(0), jnp.zeros((1, f, h // 8, w // 8, 4)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 48)),
                          pose_features=pose_feats)["params"],
        "vae": shapes(JVAE(block_out_channels=(32, 32, 64, 64)),
            jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"],
        "clip_text": shapes(JCLIP(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4),
            jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))["params"],
        "pose_encoder": shapes(JPose(channels=CHS, temporal_attention_nhead=4),
            jax.random.PRNGKey(3), jnp.zeros((1, f, h, w, 6)))["params"],
    }


_PORT = {
    "unet": lambda: UNet3D(**unet_kwargs()),
    "vae": lambda: AutoencoderKL((32, 32, 64, 64)),
    "clip_text": lambda: CLIPTextModel(1000, 64, 2, 4),
    "pose_encoder": lambda: CameraPoseEncoder(channels=CHS, temporal_attention_nhead=4),
}


@pytest.fixture(scope="module")
def tiny_jax_params():
    return _tiny_jax_params()


@pytest.mark.parametrize("kind", sorted(_PORT))
def test_weights_load_strict_and_match_exporter(tiny_jax_params, kind):
    params = randomize(tiny_jax_params[kind], seed=3)
    ours = jax_state_dict(params, kind)
    ref = export_torch_state(params, kind)
    assert set(ours) == set(ref)
    for name, arr in ref.items():
        np.testing.assert_array_equal(ours[name], np.asarray(arr, np.float32), err_msg=name)
    module = load_jax_params(_PORT[kind](), {"params": params}, kind)
    sd = module.state_dict()
    assert set(sd) == set(ref)
    for name, arr in ref.items():
        np.testing.assert_array_equal(sd[name].numpy(), np.asarray(arr, np.float32), err_msg=name)
