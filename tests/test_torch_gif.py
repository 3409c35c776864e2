"""The port's GIF reader (synfmc_tpu_torch/utils/video.py:decode_gif) against
imageio.v2.mimread(...)[..., :3] (Pillow underneath), bit for bit: GIFs that
imageio writes (LZW-compressed, local tables, sub-rectangle frames), GIFs
that the port's encoder writes, and hand-built ones for interlacing, local
colour tables, transparent indices and each disposal method."""

import io

import imageio.v2 as imageio
import numpy as np
import pytest

from synfmc_tpu_torch.utils.video import decode_gif, encode_gif, palette, quantize, read_gif


def mimread(data: bytes) -> np.ndarray:
    return np.stack([np.asarray(f)[..., :3] for f in imageio.mimread(io.BytesIO(data),
                                                                     format="GIF")])


def imageio_gif(frames) -> bytes:
    buf = io.BytesIO()
    imageio.mimwrite(buf, list(frames), format="GIF")
    return buf.getvalue()


def assert_same(data: bytes) -> np.ndarray:
    got, want = decode_gif(data), mimread(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("f,h,w", [(3, 16, 24), (5, 37, 53), (2, 64, 96)])
def test_imageio_noise_frames(f, h, w):
    rng = np.random.default_rng(h)
    assert_same(imageio_gif((rng.uniform(size=(f, h, w, 3)) * 255).astype(np.uint8)))


def test_imageio_smooth_frames_compress():
    """Gradients give long LZW strings, codes up to 12 bits and table resets."""
    y, x = np.mgrid[0:90, 0:120]
    frames = np.stack([np.stack([(x * 2 + t * 9) % 256, (y * 3) % 256,
                                 (x + y + 40 * t) % 256], -1) for t in range(4)]).astype(np.uint8)
    data = imageio_gif(frames)
    assert len(data) < frames.size // 3  # compressed: the general decoder ran
    assert_same(data)


def test_imageio_still_and_subrectangle_frames():
    rng = np.random.default_rng(3)
    base = (rng.uniform(size=(40, 56, 3)) * 255).astype(np.uint8)
    frames = [base, base.copy(), base.copy(), base.copy()]  # a still, then changes in a box
    frames[2][10:18, 20:31] = 255 - frames[2][10:18, 20:31]
    frames[3][30:38, 2:9] = (rng.uniform(size=(8, 7, 3)) * 255).astype(np.uint8)
    assert_same(imageio_gif(np.stack(frames)))


@pytest.mark.parametrize("f,h,w", [(2, 8, 8), (3, 37, 61)])
def test_port_encoder_round_trip(f, h, w):
    """decode_gif(encode_gif(x)) is x through the writer's palette, and
    imageio reads the same."""
    rng = np.random.default_rng(f * h)
    x = (rng.uniform(size=(f, h, w, 3)) * 255).astype(np.uint8)
    got = assert_same(encode_gif(x))
    np.testing.assert_array_equal(got, palette()[quantize(x)])


# ---- hand-built GIFs ----------------------------------------------------


def _lzw(indices, min_size: int) -> bytes:
    """A literal code stream: a clear code before every run of 2**min_size - 2
    indices, so that codes keep min_size + 1 bits."""
    clear, run = 1 << min_size, (1 << min_size) - 2
    codes = []
    px = [int(v) for v in np.asarray(indices).ravel()]
    for i in range(0, len(px), run):
        codes += [clear] + px[i:i + run]
    codes.append(clear + 1)
    width, acc, nbits, out = min_size + 1, 0, 0, bytearray()
    for c in codes:
        acc |= c << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return bytes([min_size]) + blocks + b"\x00"


def _table(colors) -> tuple[bytes, int]:
    colors = np.asarray(colors, np.uint8)
    bits = max(1, int(np.ceil(np.log2(len(colors)))))
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:len(colors)] = colors
    return full.tobytes(), bits - 1


def build_gif(width, height, frames, global_colors=None, background=0) -> bytes:
    """frames: dicts of x, y, idx (h, w), and optional colors (a local
    table), transparency, disposal, interlace."""
    u16 = lambda v: int(v).to_bytes(2, "little")
    out = [b"GIF89a", u16(width), u16(height)]
    if global_colors is not None:
        table, size = _table(global_colors)
        out += [bytes([0x80 | 0x70 | size, background, 0]), table]
    else:
        out.append(bytes([0, background, 0]))
    for fr in frames:
        idx = np.asarray(fr["idx"], np.uint8)
        h, w = idx.shape
        trans = fr.get("transparency")
        packed = (fr.get("disposal", 0) << 2) | (1 if trans is not None else 0)
        out.append(b"\x21\xf9\x04" + bytes([packed]) + u16(10) + bytes([trans or 0, 0]))
        flags, table = 0, b""
        if fr.get("colors") is not None:
            table, size = _table(fr["colors"])
            flags |= 0x80 | size
        rows = idx
        if fr.get("interlace"):
            flags |= 0x40
            order = np.concatenate([np.arange(s, h, st) for s, st in ((0, 8), (4, 8), (2, 4),
                                                                      (1, 2))])
            rows = idx[order]
        out += [b"\x2c", u16(fr["x"]), u16(fr["y"]), u16(w), u16(h), bytes([flags]), table,
                _lzw(rows, 8)]
    out.append(b"\x3b")
    return b"".join(out)


def _colors(rng, n):
    return (rng.uniform(size=(n, 3)) * 255).astype(np.uint8)


def test_interlaced():
    rng = np.random.default_rng(5)
    frames = [dict(x=0, y=0, idx=rng.integers(0, 16, size=(21, 13)), interlace=True),
              dict(x=3, y=5, idx=rng.integers(0, 16, size=(11, 7)), interlace=True)]
    assert_same(build_gif(13, 21, frames, global_colors=_colors(rng, 16)))


def test_local_table_and_transparent_index():
    rng = np.random.default_rng(6)
    frames = [dict(x=2, y=1, idx=rng.integers(0, 8, size=(9, 10)), transparency=3),
              dict(x=0, y=0, idx=rng.integers(0, 4, size=(12, 14)), colors=_colors(rng, 4),
                   transparency=1),
              dict(x=4, y=3, idx=rng.integers(0, 8, size=(5, 6)), colors=_colors(rng, 8))]
    assert_same(build_gif(14, 12, frames, global_colors=_colors(rng, 8), background=5))


@pytest.mark.parametrize("disposals", [(0, 1, 0), (2, 2, 2), (3, 3, 3), (1, 2, 3), (3, 0, 2)])
@pytest.mark.parametrize("transparent", [False, True])
def test_disposal_methods(disposals, transparent):
    rng = np.random.default_rng(sum(disposals) + transparent)
    frames = []
    for i, d in enumerate(disposals + (0,)):
        h, w = rng.integers(3, 9, size=2)
        fr = dict(x=int(rng.integers(0, 16 - w)), y=int(rng.integers(0, 12 - h)),
                  idx=rng.integers(0, 8, size=(h, w)), disposal=d)
        if transparent:
            fr["transparency"] = int(rng.integers(0, 8))
        if i == 2:  # a local table shorter than the background index
            fr["colors"] = _colors(rng, 4)
            fr["idx"] = fr["idx"] % 4
            fr["transparency"] = fr.get("transparency", 0) % 4 if transparent else None
        frames.append(fr)
    assert_same(build_gif(16, 12, frames, global_colors=_colors(rng, 8), background=6))


def test_read_gif_and_errors(tmp_path):
    x = np.zeros((2, 4, 4, 3), np.uint8)
    path = tmp_path / "a.gif"
    path.write_bytes(encode_gif(x))
    np.testing.assert_array_equal(read_gif(str(path)), decode_gif(encode_gif(x)))
    with pytest.raises(ValueError, match="not a GIF"):
        decode_gif(b"PNG....")
