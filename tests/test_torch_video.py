"""The port's GIF writer read back by imageio (and held to the JAX package's
``save_videos_grid`` on palette-exact colours), and its camera-file parser
against the JAX package's on files the JAX package writes."""

import numpy as np
import imageio.v2 as imageio
import pytest
from PIL import Image

from synfmc_tpu.evaluation.metrics import parse_camera_txt as jax_parse_camera_txt
from synfmc_tpu.utils.video import save_camera_info_txt
from synfmc_tpu.utils.video import save_videos_grid as jax_save_videos_grid
from synfmc_tpu_torch.evaluation.metrics import parse_camera_text, parse_camera_txt
from synfmc_tpu_torch.utils.video import (
    PALETTE_MAX_ERROR,
    encode_gif,
    palette,
    save_videos_grid,
    video_grid,
)


def read_gif(path):
    """imageio's frames (RGB) and metadata of a GIF."""
    frames = np.stack([f[..., :3] for f in imageio.mimread(path)])
    with imageio.get_reader(path) as reader:
        meta = reader.get_meta_data()
    return frames, meta


@pytest.mark.parametrize("shape,fps,kind", [
    ((1, 16, 32, 48, 3), 8, "float"),
    ((3, 2, 9, 11, 3), 8, "uint8"),  # a grid of 3 rows, odd sizes
    ((6, 3, 8, 8, 3), 5, "float"),  # 4 rows x 2 columns
    ((1, 1, 1, 1, 3), 8, "uint8"),
], ids=["clip", "grid3", "grid6_fps5", "one_pixel"])
def test_gif_reads_back_within_the_palette_bound(tmp_path, shape, fps, kind):
    rng = np.random.default_rng(0)
    videos = rng.uniform(size=shape).astype(np.float32)
    if kind == "uint8":
        videos = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "sub" / "clip.gif")
    save_videos_grid(videos, path, fps=fps)
    frames, meta = read_gif(path)
    want = video_grid(videos)
    b, f, h, w, _ = shape
    rows = min(4, b)
    assert frames.shape == (f, rows * h, -(-b // rows) * w, 3) == want.shape
    assert meta["loop"] == 0
    assert meta["duration"] == 10 * round(100 / fps)
    err = np.abs(frames.astype(int) - want.astype(int)).reshape(-1, 3).max(axis=0)
    assert (err <= np.asarray(PALETTE_MAX_ERROR)).all(), (err, PALETTE_MAX_ERROR)
    with Image.open(path) as im:
        assert im.n_frames == f and im.info["loop"] == 0


def test_palette_bound_is_tight():
    """Each channel's bound is reached by some value and never exceeded."""
    pal = palette()[:252].astype(int)
    for c, bound in enumerate(PALETTE_MAX_ERROR):
        levels = np.unique(pal[:, c])
        worst = max(np.abs(levels - v).min() for v in range(256))
        assert worst == bound


def test_layout_matches_jax_on_palette_exact_colours(tmp_path):
    """Flat colours both palettes hold exactly: the JAX package's GIF (imageio)
    and the port's decode to the same frames, loop and duration."""
    colours = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 255], [0, 0, 0]],
                       np.uint8)
    videos = np.zeros((5, 3, 6, 7, 3), np.uint8)
    for i in range(5):
        for t in range(3):
            videos[i, t] = colours[(i + t) % 5]
    ours, theirs = str(tmp_path / "port.gif"), str(tmp_path / "jax.gif")
    save_videos_grid(videos, ours)
    jax_save_videos_grid(videos, theirs)
    (f_ours, m_ours), (f_theirs, m_theirs) = read_gif(ours), read_gif(theirs)
    np.testing.assert_array_equal(f_ours, f_theirs)
    assert (m_ours["loop"], m_ours["duration"]) == (m_theirs["loop"], m_theirs["duration"])


def test_gif_code_stream_stays_nine_bits():
    """The literal stream: a clear code before every 254 indices, so one
    frame of 1000 pixels has ceil(1000 / 254) = 4 clears and the end code."""
    frames = np.zeros((1, 10, 100, 3), np.uint8)
    data = encode_gif(frames)
    assert data[:6] == b"GIF89a" and data[-1:] == b"\x3b"
    start = data.index(b"\x2c") + 10
    assert data[start] == 8  # LZW minimum code size
    payload, i = bytearray(), start + 1
    while data[i]:
        payload += data[i + 1:i + 1 + data[i]]
        i += 1 + data[i]
    bits = np.unpackbits(np.frombuffer(bytes(payload), np.uint8), bitorder="little")
    n = 1000 + 4 + 1
    codes = bits[:n * 9].reshape(n, 9) @ (1 << np.arange(9))
    assert codes[-1] == 257 and (codes[::255][:4] == 256).all()
    assert (codes[:-1] != 257).all() and (codes < 512).all()


def test_camera_file_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    intr = rng.uniform(100, 400, size=(16, 4))
    rts = rng.normal(size=(16, 3, 4))
    path = str(tmp_path / "cam.txt")
    save_camera_info_txt(path, intr, rts)
    want = jax_parse_camera_txt(path)
    for got in (parse_camera_txt(path), parse_camera_text(open(path).read())):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
