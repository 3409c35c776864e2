"""The port's data layer against the JAX package's, on the CPU.

PNGs written by PIL (L, LA, RGB, RGBA, P with and without tRNS) and by a
writer of this file that cycles the five row filters over several IDAT
chunks; the port's ``imread`` and ``decode_resize_batch`` (C++) and their
numpy versions against ``np.array(Image.open(...))``, PIL's
``convert("RGB").resize(BILINEAR)`` and ``synfmc_tpu.native.fastimage``, bit
for bit.  A fixture of 2 sequences x 48 frames at 64x96, written by the
port's fixture writer, read by both packages' ``UnrealTrajVideoDataset``
and ``ShardedLoader``: every array equal, every caption equal, the same
batch sequence.  Both packages' config schemas and auto-resume scans on
the same inputs.  No JAX program runs.
"""

import copy
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from synfmc_tpu.config import load_config as jax_load_config
from synfmc_tpu.data.dataset import UnrealTrajVideoDataset as JDataset
from synfmc_tpu.data.loader import ShardedLoader as JLoader
from synfmc_tpu.native import fastimage
from synfmc_tpu.training import checkpoint as jckpt
from synfmc_tpu.training.config_schema import ConfigError as JConfigError
from synfmc_tpu.training.config_schema import validate_config as jax_validate_config
from synfmc_tpu_torch.data import image
from synfmc_tpu_torch.data.dataset import UnrealTrajVideoDataset
from synfmc_tpu_torch.data.fixture import build_synthetic_dataset
from synfmc_tpu_torch.data.loader import ShardedLoader, WorkerError
from synfmc_tpu_torch.training import checkpoint as ckpt
from synfmc_tpu_torch.training.config_schema import ConfigError, validate_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 60, 90  # resized down 2x, down 1.875x and up 1.5x below
SIZES = [(30, 45), (32, 48), (90, 135)]
MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_filtered_png(path, px, color, palette=None, trns=None, n_idat=3):
    """An 8-bit PNG whose row r uses filter r % 5, its stream cut over
    ``n_idat`` IDAT chunks.  px: (H, W, C) uint8 (indices for palette)."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int64)
    out = []
    for r in range(h):
        cur = rows[r]
        up = rows[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        ft = r % 5
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][ft]
        out.append(bytes([ft]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    data = zlib.compress(b"".join(out))
    cuts = np.linspace(0, len(data), n_idat + 1).astype(int)
    chunk = lambda kind, body: (struct.pack(">I", len(body)) + kind + body
                                + struct.pack(">I", zlib.crc32(kind + body)))
    blob = image.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        blob += chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        blob += chunk(b"tRNS", trns)
    for a, b in zip(cuts[:-1], cuts[1:]):
        blob += chunk(b"IDAT", data[a:b])
    with open(path, "wb") as fh:
        fh.write(blob + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    content = {
        "noise": rng.integers(0, 256, (H, W, 4), dtype=np.uint8),
        # smooth rows make PIL's writer pick filters other than 0
        "smooth": np.stack([(2 * xx + yy) % 256, (3 * yy) % 256, (xx * yy) % 256,
                            (xx + 5 * yy) % 256], -1).astype(np.uint8),
    }
    files = {}
    for tag, px in content.items():
        for mode, c in MODES.items():
            files[f"pil_{tag}_{mode}"] = root / f"pil_{tag}_{mode}.png"
            Image.fromarray(px[..., 0] if c == 1 else px[..., :c], mode).save(
                files[f"pil_{tag}_{mode}"])
        quant = Image.fromarray(px[..., :3]).quantize(256)
        files[f"pil_{tag}_P"] = root / f"pil_{tag}_P.png"
        quant.save(files[f"pil_{tag}_P"])
        files[f"pil_{tag}_P_trns"] = root / f"pil_{tag}_P_trns.png"
        quant.save(files[f"pil_{tag}_P_trns"], transparency=5)
    px = content["noise"]
    for mode, c in MODES.items():
        files[f"filters_{mode}"] = root / f"filters_{mode}.png"
        write_filtered_png(files[f"filters_{mode}"], px[..., :c], {1: 0, 2: 4, 3: 2, 4: 6}[c])
    palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    files["filters_P_trns"] = root / "filters_P_trns.png"
    write_filtered_png(files["filters_P_trns"], (px[..., :1] % 200).astype(np.uint8), 3,
                       palette=palette, trns=bytes(range(0, 200, 2)))
    return {k: str(v) for k, v in files.items()}


NAMES = ([f"pil_{t}_{m}" for t in ("noise", "smooth") for m in (*MODES, "P", "P_trns")]
         + [f"filters_{m}" for m in (*MODES, "P_trns")])


@pytest.mark.parametrize("name", NAMES)
def test_imread_matches_pil_bit_for_bit(pngs, name):
    path = pngs[name]
    want = np.array(Image.open(path))
    got = image.imread(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fastimage.imread(path))
    header, raw, _ = image.read_png(path)
    rowbytes = got.size // got.shape[0]
    bpp = image.CHANNELS[header["color"]]
    plain = image.unfilter_plain(raw, got.shape[0], rowbytes, bpp)
    np.testing.assert_array_equal(plain.reshape(got.shape), got)
    if name.startswith("filters"):
        assert set(np.frombuffer(raw, np.uint8)[::rowbytes + 1]) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("name", NAMES)
def test_decode_resize_matches_pil_and_fastimage(pngs, name):
    path = pngs[name]
    rgb = Image.open(path).convert("RGB")
    for h, w in SIZES:
        want = np.asarray(rgb.resize((w, h), Image.BILINEAR), dtype=np.float32) / 255.0
        got = image.decode_resize_batch([path, path], h, w)
        assert got.shape == (2, h, w, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got[0], want)
        np.testing.assert_array_equal(got[1], want)
        native = fastimage.decode_resize_batch([path], h, w)  # None: the JAX package uses PIL
        if native is not None:
            np.testing.assert_array_equal(got[0], native[0])
        plain = image.resize_plain(image.to_rgb(path), h, w)
        np.testing.assert_array_equal(plain, np.asarray(rgb.resize((w, h), Image.BILINEAR)))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_writer_decodes_under_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (13, 17) if channels == 1 else (13, 17, channels), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    image.write_png(path, px)
    np.testing.assert_array_equal(np.array(Image.open(path)), px)
    np.testing.assert_array_equal(image.imread(path), px)


def _rewrite_ihdr(src, dst, **fields):
    data = open(src, "rb").read()
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    vals = {"depth": depth, "interlace": interlace, **fields}
    body = struct.pack(">IIBBBBB", w, h, vals["depth"], color, comp, filt, vals["interlace"])
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    with open(dst, "wb") as fh:
        fh.write(data[:16] + body + crc + data[33:])


@pytest.mark.parametrize("case,match", [
    ("sixteen_bit", "bit depth 16"), ("interlaced", "interlaced"), ("bad_crc", "bad CRC"),
    ("not_png", "not a PNG")])
def test_unsupported_png_raises_with_its_name(pngs, tmp_path, case, match):
    path = str(tmp_path / f"{case}.png")
    if case == "sixteen_bit":
        Image.fromarray(np.arange(64 * 64, dtype=np.uint16).reshape(64, 64)).save(path)
    elif case == "interlaced":
        _rewrite_ihdr(pngs["pil_noise_RGB"], path, interlace=1)
    elif case == "bad_crc":
        data = bytearray(open(pngs["pil_noise_RGB"], "rb").read())
        data[40] ^= 0xFF
        open(path, "wb").write(bytes(data))
    else:
        open(path, "wb").write(b"GIF89a")
    with pytest.raises(image.PNGError, match=match) as err:
        image.decode_resize_batch([path], 8, 8)
    assert path in str(err.value)


# ---------------------------------------------------------------------------
# the dataset and the loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset_kwargs(tmp_path_factory):
    root = tmp_path_factory.mktemp("synfmc_data")
    return build_synthetic_dataset(str(root), num_seqs=2, num_objects=2, num_frames=48)


VARIANTS = {
    "cam_yaml": {},
    "flip_sphere": dict(use_flip=True, use_sphere_mask=True, cam_translation_rescale_factor=1200,
                        obj_translation_rescale_factor=1000),
    "change_tgt": dict(allow_change_tgt=True, tgt_fps_list=[16, 8, 4]),
}


def _params(dataset_kwargs, variant):
    return dict(dataset_kwargs, sample_size=[32, 48], sample_n_frames=4, max_objects=2,
                **VARIANTS[variant])


def assert_same_item(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("seed", [0, 7])
def test_dataset_items_match_jax_exactly(dataset_kwargs, variant, seed):
    params = _params(dataset_kwargs, variant)
    port, ref = UnrealTrajVideoDataset(**params, seed=seed), JDataset(**params, seed=seed)
    assert len(port) == len(ref) == 2
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        items = []
        for idx in (1, 0):
            got, want = port[idx], ref[idx]
            assert isinstance(got["caption"], str) and got["caption"]
            assert_same_item(got, want)
            items.append((got, want))
        assert_same_item(UnrealTrajVideoDataset.collate_fn([g for g, _ in items]),
                         JDataset.collate_fn([w for _, w in items]))


def test_loader_order_matches_jax(dataset_kwargs):
    params = _params(dataset_kwargs, "cam_yaml")
    ref = JLoader(JDataset(**params, seed=3), batch_size=1, collate_fn=JDataset.collate_fn,
                  seed=5, num_workers=0, process_index=0, process_count=1)
    want = [b for _, b in zip(range(5), ref.epochs(start_epoch=1, start_batch=1))]
    for workers in (0, 2):
        port = ShardedLoader(UnrealTrajVideoDataset(**params, seed=3), batch_size=1,
                             collate_fn=UnrealTrajVideoDataset.collate_fn, seed=5,
                             num_workers=workers)
        try:
            assert len(port) == len(ref) == 2
            got = [b for _, b in zip(range(5), port.epochs(start_epoch=1, start_batch=1))]
        finally:
            port.close()
        assert [e for e, _ in got] == [e for e, _ in want] == [1, 2, 2, 3, 3]
        for (_, g), (_, w) in zip(got, want):
            assert_same_item(g, w)


class _CudaInWorker:
    def __len__(self):
        return 2

    def set_epoch(self, epoch):
        pass

    def __getitem__(self, idx):
        torch.zeros(1, device="cuda")


def test_worker_cuda_use_raises_in_the_parent():
    loader = ShardedLoader(_CudaInWorker(), batch_size=1, collate_fn=list, num_workers=1)
    try:
        with pytest.raises(WorkerError, match="CUDA used inside a data-loader worker"):
            next(loader.epochs())
    finally:
        loader.close()


# ---------------------------------------------------------------------------
# the config schema and the auto-resume scan
# ---------------------------------------------------------------------------

EDITS = {
    "shipped": {},
    "typo_top": {"learning_rat": 1e-4},
    "typo_nested": {"pose_encoder_kwargs": {"downscale_factr": 8}},
    "bad_value": {"attention_processor_kwargs": {"add_spatial": True}},
    "extension": {"prefetch_batches": 2, "record_loss_history": True},
    "inert": {"launcher": "pytorch", "port": 29500},
    "unknown_allowed": {"allow_unknown_config_keys": True, "bogus": 1},
    "scheduler_kwarg": {"noise_scheduler_kwargs": {"prediction_type": "v"}},
    "accumulation": {"gradient_accumulation_steps": 0},
}


@pytest.mark.parametrize("stage", ["lora", "cam", "obj"])
@pytest.mark.parametrize("edit", sorted(EDITS))
def test_validate_config_matches_jax(stage, edit):
    cfg = jax_load_config(os.path.join(REPO, "configs", f"{stage}.yaml")).to_dict()
    for key, value in EDITS[edit].items():
        if isinstance(value, dict) and isinstance(cfg.get(key), dict):
            cfg[key] = {**cfg[key], **value}
        else:
            cfg[key] = value
    outcomes = []
    for fn, error in ((jax_validate_config, JConfigError), (validate_config, ConfigError)):
        try:
            outcomes.append(("ok", fn(copy.deepcopy(cfg), stage)))
        except error as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0][0] == "ok") == (edit in ("shipped", "extension", "inert",
                                                 "unknown_allowed"))


def test_auto_resume_scan_matches_jax(tmp_path):
    out = tmp_path / "out"
    tree = {
        "cam-2026-01-02T03-04": ["step-2", "step-10", "step-3.tmp-99", "cmcm-step-10.ckpt"],
        "cam-2026-01-02T05-06": ["step-4"],
        "cam-hires-2026-01-02T03-04": ["step-50"],
        "cam": ["step-7"],
        "cam-2026-01-02": ["step-90"],
        "other-2026-01-02T03-04": ["step-99"],
        "cam-2026-01-03T00-00": [],
    }
    for run, entries in tree.items():
        os.makedirs(out / run / "checkpoints")
        for e in entries:
            os.makedirs(out / run / "checkpoints" / e)
    for name, want_step in (("cam", 10), ("other", 99), ("cam-hires", 50), ("none", None)):
        got, want = ckpt.find_auto_resume(str(out), name), jckpt.find_auto_resume(str(out), name)
        assert got == want
        assert (got is None) if want_step is None else got.endswith(f"step-{want_step}")
    for run in tree:
        d = str(out / run / "checkpoints")
        assert ckpt.latest_native(d) == jckpt.latest_native(d)
    assert ckpt.find_auto_resume(str(tmp_path / "missing"), "cam") is None
