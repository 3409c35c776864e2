"""Render and camera-label files: the counterpart of synfmc_tpu/utils/
video.py.  ``save_videos_grid`` (the reference's fmc/utils/util.py:36-48)
writes an animated GIF by this package's own GIF89a encoder;
``save_image_grid`` a PNG by ``data/image.py``'s writer (the JAX package uses
imageio for both); ``save_camera_info_txt`` and ``save_camera_label_txt``
the camera dumps of train_cam_ctrl.py:41-74, line for line as the JAX
package writes them.

``decode_gif`` / ``read_gif`` read a GIF back as (F, H, W, 3) uint8 frames,
what ``imageio.v2.mimread(path)[..., :3]`` gives through Pillow: a full LZW
decoder (code widths up to 12 bits, clear and end codes, the deferred clear
at 4096 entries), global and local colour tables, sub-rectangle frames, the
transparent index, interlaced rows and disposal methods 0-3 composited as
Pillow composites them (see ``decode_gif``).

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


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

_MAX_CODES = 4096


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The data sub-blocks from ``pos`` up to their terminator, joined, and
    the position after it."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF: a data sub-block runs past the end")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(data[pos:pos + n])
        pos += n


def _literal_stream(data: bytes, min_size: int):
    """The pixel indices of a stream of literal codes at the first width (as
    ``encode_gif`` writes it), decoded at once; None when the stream holds
    any other code or a run of codes long enough to widen them."""
    width, clear = min_size + 1, 1 << min_size
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    n = len(bits) // width
    codes = bits[:n * width].reshape(n, width).astype(np.int64) @ (1 << np.arange(width))
    ends = np.flatnonzero(codes == clear + 1)
    if not len(ends):
        return None
    codes = codes[:ends[0]]
    if (codes > clear).any():
        return None
    # a run of more than (1 << width) - clear - 2 codes between clears widens the codes
    bounds = np.concatenate([[-1], np.flatnonzero(codes == clear), [len(codes)]])
    if (np.diff(bounds) - 1 > (1 << width) - clear - 2).any():
        return None
    return codes[codes != clear].astype(np.uint8)


def _lzw_decode(data: bytes, min_size: int, limit: int) -> np.ndarray:
    """GIF LZW: the pixel indices of one image's code stream (at most
    ``limit``)."""
    if not 2 <= min_size <= 8:
        raise ValueError(f"GIF LZW minimum code size {min_size} outside 2..8")
    fast = _literal_stream(data, min_size)
    if fast is not None:
        return fast[:limit]
    clear, end = 1 << min_size, (1 << min_size) + 1
    roots = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(roots)
    size = min_size + 1
    mask = (1 << size) - 1
    out, n, prev = [], 0, None
    acc = nbits = 0
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= size:
            code = acc & mask
            acc >>= size
            nbits -= size
            if code == clear:
                table = list(roots)
                size = min_size + 1
                mask = (1 << size) - 1
                prev = None
                continue
            if code == end:
                return np.frombuffer(b"".join(out), np.uint8)[:limit]
            if prev is None:
                if code >= clear:
                    raise ValueError(f"GIF LZW: code {code} before any entry")
                entry = table[code]
            else:
                nxt = len(table)
                if code < nxt:
                    entry = table[code]
                    new = prev + entry[:1]
                elif code == nxt:
                    entry = new = prev + prev[:1]
                else:
                    raise ValueError(f"GIF LZW: code {code} beyond the table's {nxt}")
                if nxt < _MAX_CODES:  # a full table stays as it is until a clear
                    table.append(new)
                    if len(table) == 1 << size and size < 12:
                        size += 1
                        mask = (1 << size) - 1
            out.append(entry)
            prev = entry
            n += len(entry)
            if n >= limit:
                return np.frombuffer(b"".join(out), np.uint8)[:limit]
    return np.frombuffer(b"".join(out), np.uint8)  # no end code: what there is


def _palette_rgb(table) -> np.ndarray:
    """A colour table as 256 RGB rows: past its entries, or without a table,
    index i reads as grey i (Pillow's default palette)."""
    out = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    if table is not None:
        out[:len(table)] = table
    return out


def _interlaced_rows(h: int) -> np.ndarray:
    """The row of each decoded line of an interlaced image: passes from rows
    0, 4, 2, 1 with steps 8, 8, 4, 2."""
    return np.concatenate([np.arange(start, h, step)
                           for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))])


def decode_gif(data: bytes) -> np.ndarray:
    """The frames of a GIF as (F, H, W, 3) uint8, composited as Pillow
    composites them (its RGB_AFTER_FIRST strategy, which imageio reads
    through):

    - frame 0: the logical screen filled with the frame's transparent index
      (else index 0), its rectangle's pixels written whatever their index,
      every index through the frame's table (local, else global);
    - later frames: first the previous frame's disposal (2: its rectangle
      filled with the colour of its transparent index, else of the
      background index; 3: its rectangle restored to what it held before
      that frame was drawn, or, for frame 0, filled with its transparent
      index's colour when it has one); then the rectangle's pixels drawn,
      the transparent index's left as they are;
    - a frame without a disposal method (0) keeps the previous frame's, as
      Pillow does.
    """
    data = bytes(data)
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF (no GIF87a/GIF89a signature)")
    u16 = lambda p: data[p] | data[p + 1] << 8
    sw, sh, flags = u16(6), u16(8), data[10]
    background = data[11] if flags & 0x80 else 0  # Pillow reads it with a global table only
    pos = 13
    global_table = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        global_table = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    frames, canvas, pending = [], None, None
    disposal, transparency = 0, None
    while pos < len(data):
        block = data[pos]
        pos += 1
        if block == 0x3B:  # trailer
            break
        if block == 0x21:  # extension
            label = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4:  # graphic control
                if body[0] >> 2 & 7:
                    disposal = body[0] >> 2 & 7
                transparency = body[3] if body[0] & 1 else None
            continue
        if block != 0x2C:
            raise ValueError(f"unexpected GIF block 0x{block:02x} at byte {pos - 1}")
        x0, y0, w, h, iflags = u16(pos), u16(pos + 2), u16(pos + 4), u16(pos + 6), data[pos + 8]
        pos += 9
        table = global_table
        if iflags & 0x80:
            n = 2 << (iflags & 7)
            table = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
            pos += 3 * n
        if x0 + w > sw or y0 + h > sh:
            raise ValueError(f"GIF frame {len(frames)} ({x0},{y0} {w}x{h}) leaves the "
                             f"{sw}x{sh} screen")
        min_size = data[pos]
        stream, pos = _sub_blocks(data, pos + 1)
        pixels = _lzw_decode(stream, min_size, w * h)
        rgb = _palette_rgb(table)
        idx = np.full(w * h, 0 if transparency is None else transparency, np.uint8)
        idx[:len(pixels)] = pixels
        idx = idx.reshape(h, w)
        if iflags & 0x40:
            rows = np.empty_like(idx)
            rows[_interlaced_rows(h)] = idx
            idx = rows
        rect = (slice(y0, y0 + h), slice(x0, x0 + w))
        if canvas is None:
            full = np.full((sh, sw), 0 if transparency is None else transparency, np.uint8)
            full[rect] = idx
            canvas = rgb[full]
            if disposal == 2:
                pending = (rect, rgb[background if transparency is None else transparency])
            elif disposal == 3 and transparency is not None:
                pending = (rect, rgb[transparency])
            else:
                pending = None
        else:
            if pending is not None:
                canvas[pending[0]] = pending[1]
            if disposal == 2:
                color = background if transparency is None else transparency
                if table is not None and color >= len(table):
                    color = 0
                pending = (rect, rgb[color])
            elif disposal == 3:
                pending = (rect, canvas[rect].copy())
            else:
                pending = None
            drawn = np.ones(idx.shape, bool) if transparency is None else idx != transparency
            canvas[rect][drawn] = rgb[idx[drawn]]
        frames.append(canvas.copy())
        transparency = None
    if not frames:
        raise ValueError("GIF holds no image")
    return np.stack(frames)


def read_gif(path: str) -> np.ndarray:
    """The frames of the GIF at ``path`` as (F, H, W, 3) uint8
    (:func:`decode_gif`)."""
    with open(path, "rb") as fh:
        return decode_gif(fh.read())

