"""Render and camera-label files: the counterpart of synfmc_tpu/utils/
video.py.  ``save_videos_grid`` (the reference's fmc/utils/util.py:36-48)
writes an animated GIF by this package's own GIF89a encoder;
``save_image_grid`` a PNG by ``data/image.py``'s writer (the JAX package uses
imageio for both); ``save_camera_info_txt`` and ``save_camera_label_txt``
the camera dumps of train_cam_ctrl.py:41-74, line for line as the JAX
package writes them.

The encoder (numpy, no image library):
- one global palette, a fixed 6x7x6 RGB cube (252 colours, 4 unused
  entries), each channel quantized to its nearest level; the largest error
  per channel is ``PALETTE_MAX_ERROR`` (25, 21, 25 for R, G, B);
- a NETSCAPE2.0 application block with the loop count, then per frame a
  Graphic Control Extension (delay ``round(100 / fps)`` centiseconds) and a
  full-size image;
- LZW with minimum code size 8 as a literal code stream: a clear code (256)
  before every 254 pixel indices, so the decoder's table never reaches 512
  entries and every code stays 9 bits; the end code 257 last; packed LSB
  first in 255-byte sub-blocks.  About 9/8 bytes a pixel: no compression,
  and no Python loop over pixels.
"""

from __future__ import annotations

import os

import numpy as np

from synfmc_tpu_torch.data.image import write_png

LEVELS = (6, 7, 6)  # palette levels of R, G, B
_CLEAR, _EOI, _CODE_BITS = 256, 257, 9
_RUN = 254  # literals between clear codes: 258 + 253 table entries < 512


def _levels(n: int) -> np.ndarray:
    return np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.int64)


def _nearest_lut(n: int) -> np.ndarray:
    """uint8 value -> index of its nearest level."""
    return np.abs(np.arange(256)[:, None] - _levels(n)[None, :]).argmin(axis=1).astype(np.int64)


_LUTS = tuple(_nearest_lut(n) for n in LEVELS)
PALETTE_MAX_ERROR = tuple(int(np.abs(np.arange(256) - _levels(n)[lut]).max())
                          for n, lut in zip(LEVELS, _LUTS))


def palette() -> np.ndarray:
    """(256, 3) uint8: the cube, index r*42 + g*6 + b, then black."""
    r, g, b = np.meshgrid(*(_levels(n) for n in LEVELS), indexing="ij")
    cube = np.stack([r.ravel(), g.ravel(), b.ravel()], axis=1)
    out = np.zeros((256, 3), np.uint8)
    out[:len(cube)] = cube
    return out


def quantize(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) palette indices."""
    r, g, b = (_LUTS[c][frame[..., c]] for c in range(3))
    return (r * (LEVELS[1] * LEVELS[2]) + g * LEVELS[2] + b).astype(np.uint8)


def _lzw_literal(indices: np.ndarray) -> bytes:
    """The image data of one frame: code size byte, sub-blocks, terminator."""
    px = indices.ravel().astype(np.uint16)
    nblk = -(-len(px) // _RUN)
    blocks = np.full((nblk, _RUN + 1), _CLEAR, np.uint16)
    blocks[:, 1:] = np.pad(px, (0, nblk * _RUN - len(px))).reshape(nblk, _RUN)
    # the padding sits at the end of the last block: keep the clears and pixels
    codes = np.append(blocks.ravel()[:nblk + len(px)], np.uint16(_EOI))
    bits = ((codes[:, None] >> np.arange(_CODE_BITS, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.ravel(), bitorder="little")
    nfull = len(data) // 255
    full = np.hstack([np.full((nfull, 1), 255, np.uint8), data[:nfull * 255].reshape(nfull, 255)])
    tail = data[nfull * 255:]
    out = [b"\x08", full.tobytes()]
    if len(tail):
        out += [bytes([len(tail)]), tail.tobytes()]
    out.append(b"\x00")
    return b"".join(out)


def encode_gif(frames, fps: int = 8, loop: int = 0) -> bytes:
    """(F, H, W, 3) uint8 frames -> the bytes of an animated GIF."""
    frames = np.asarray(frames, np.uint8)
    f, h, w, c = frames.shape
    if c != 3 or not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"want (F, H, W, 3) frames of at most 65535 pixels a side, got "
                         f"{frames.shape}")
    u16 = lambda v: int(v).to_bytes(2, "little")
    delay = round(100 / fps)
    out = [b"GIF89a", u16(w), u16(h), b"\xf7\x00\x00", palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01", u16(loop), b"\x00"]
    for frame in frames:
        out += [b"\x21\xf9\x04\x04", u16(delay), b"\x00\x00",
                b"\x2c", u16(0), u16(0), u16(w), u16(h), b"\x00",
                _lzw_literal(quantize(frame))]
    out.append(b"\x3b")
    return b"".join(out)


def to_uint8(video) -> np.ndarray:
    """Floats in [0, 1] -> uint8 (clipped, truncated as the JAX package does);
    uint8 passes through."""
    v = np.asarray(video)
    if v.dtype != np.uint8:
        v = (np.clip(v, 0.0, 1.0) * 255).astype(np.uint8)
    return v


def video_grid(videos, n_rows: int = 4) -> np.ndarray:
    """(B, F, H, W, 3) -> (F, rows*H, cols*W, 3) uint8; sample i at row
    i % rows, column i // rows."""
    videos = to_uint8(videos)
    b, f, h, w, c = videos.shape
    n_rows = min(n_rows, b)
    n_cols = (b + n_rows - 1) // n_rows
    grid = np.zeros((f, n_rows * h, n_cols * w, c), dtype=np.uint8)
    for i in range(b):
        r, col = i % n_rows, i // n_rows
        grid[:, r * h:(r + 1) * h, col * w:(col + 1) * w] = videos[i]
    return grid


def videos_grid_gif(videos, n_rows: int = 4, fps: int = 8) -> bytes:
    """The GIF bytes ``save_videos_grid`` writes."""
    return encode_gif(video_grid(videos, n_rows), fps=fps, loop=0)


def save_videos_grid(videos, path: str, n_rows: int = 4, fps: int = 8) -> None:
    """Save (B, F, H, W, 3) videos (floats in [0, 1] or uint8) as an animated
    GIF grid that loops forever."""
    data = videos_grid_gif(videos, n_rows, fps)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(data)


def image_grid(images, n_rows: int = 4) -> np.ndarray:
    """(B, H, W, 3) -> (rows*H, cols*W, 3) uint8; image i at row i % rows,
    column i // rows."""
    return video_grid(to_uint8(images)[:, None], n_rows)[0]


def save_image_grid(images, path: str, n_rows: int = 4) -> None:
    """Save (B, H, W, 3) images (floats in [0, 1] or uint8) as a PNG grid."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, image_grid(images, n_rows))


def save_camera_info_txt(path: str, intrinsics, cam_rts) -> None:
    """Per-frame camera labels for RotErr / TransErr: the frame count, then
    ``i fx fy cx cy 0 0 r00 r01 r02 t0 r10 ... t2`` a frame."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cam_rts = np.asarray(cam_rts).reshape(len(cam_rts), -1)
    with open(path, "w") as f:
        f.write(f"{len(cam_rts)}\n")
        for i, (k, rt) in enumerate(zip(np.asarray(intrinsics), cam_rts)):
            vals = [i] + list(k[:4]) + [0, 0] + list(rt[:12])
            f.write(" ".join(str(float(v)) if j else str(int(v)) for j, v in enumerate(vals))
                    + "\n")


def save_camera_label_txt(path: str, header: str, cams) -> None:
    """A header line, then per frame seven ``-1`` fields and the row-major 3x4
    camera matrix (float64)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cams = np.asarray(cams, dtype=np.float64).reshape(len(cams), 12)
    with open(path, "w") as f:
        f.write(header + " \n")
        for cam in cams:
            f.write("-1 -1 -1 -1 -1 -1 -1 " + " ".join(str(v) for v in cam) + "\n")
