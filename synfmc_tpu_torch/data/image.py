"""PNG frames and masks for the data loader, without PIL or libpng.

The port's counterpart of synfmc_tpu/native/fastimage.{cpp,py}:

- ``imread(path)`` equals ``np.array(PIL.Image.open(path))`` for 8-bit,
  non-interlaced PNGs in gray, gray + alpha, RGB, RGBA and palette form
  (a palette image reads as its indices, as PIL gives them);
- ``decode_resize_batch(paths, h, w)`` equals the JAX dataset's
  ``_load_and_resize`` for each file (synfmc_tpu/data/dataset.py:320-326):
  ``convert("RGB")`` (alpha dropped, not composited; a palette looked up),
  ``resize((w, h), BILINEAR)``, then ``/ 255`` as float32;
- ``write_png(path, array)`` writes gray, gray + alpha, RGB or RGBA uint8
  arrays (filter 0 on every row, one IDAT chunk).

The chunks and the zlib stream are read here with the standard library;
the per-row unfiltering and Pillow's fixed-point resampler run in
``csrc/fastimage.cpp``, compiled by the host C++ compiler at first use into
the kernels' build directory (``ops/_cuda.py:build_dir``), keyed by the
source's hash, and loaded with ctypes.  ``unfilter_plain`` and
``resize_plain`` are the same arithmetic in numpy, for the tests.

There is no fallback: a PNG this reader does not take (interlaced, a bit
depth other than 8, a bad CRC or filter type) and a failed build raise,
naming the file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from synfmc_tpu_torch.ops._cuda import build_dir

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fastimage.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels of the decoded array
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"libfastimage-{h}.so"


def library() -> ctypes.CDLL:
    """The loaded ``csrc/fastimage.cpp``, compiled on first use.  The build
    goes to a file of this process's own and is renamed into place, so that
    processes building at once never load a half-written library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            cxx = shutil.which("c++")
            if cxx is None:
                raise RuntimeError(f"no host C++ compiler (c++) to build {_SOURCE}: the PNG "
                                   "reader needs it")
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {_SOURCE} failed:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        u8 = ctypes.c_void_p
        lib.sfi_unfilter.argtypes = [u8, u8, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.sfi_unfilter.restype = ctypes.c_int
        lib.sfi_resize_bilinear.argtypes = [u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8,
                                            ctypes.c_int, ctypes.c_int]
        lib.sfi_resize_bilinear.restype = ctypes.c_int
        _lib = lib
        return lib


class PNGError(ValueError):
    """A file this reader does not take."""


def read_png(path: str) -> tuple[dict, bytes, np.ndarray | None]:
    """The header fields, the inflated IDAT stream and the palette (n, 3)
    of a PNG file, every chunk's CRC checked."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != SIGNATURE:
        raise PNGError(f"{path}: not a PNG file")
    pos, header, idat, palette = 8, None, [], None
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise PNGError(f"{path}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{path}: bad CRC in the {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            header = dict(width=w, height=h, depth=depth, color=color, interlace=interlace)
            if comp != 0 or filt != 0:
                raise PNGError(f"{path}: unknown compression {comp} or filter method {filt}")
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise PNGError(f"{path}: no IHDR or no IDAT chunk")
    if header["color"] not in CHANNELS:
        raise PNGError(f"{path}: unknown colour type {header['color']}")
    if header["depth"] != 8:
        raise PNGError(f"{path}: bit depth {header['depth']} is not read (8 only)")
    if header["interlace"]:
        raise PNGError(f"{path}: interlaced PNGs are not read")
    if header["color"] == 3 and palette is None:
        raise PNGError(f"{path}: palette image without a PLTE chunk")
    return header, zlib.decompress(b"".join(idat)), palette


def _raw_rows(path: str, header: dict, raw: bytes) -> tuple[int, int, int]:
    h, c = header["height"], CHANNELS[header["color"]]
    rowbytes = header["width"] * c
    if len(raw) != h * (rowbytes + 1):
        raise PNGError(f"{path}: {len(raw)} bytes of image data, want {h * (rowbytes + 1)}")
    return h, rowbytes, c


def decode(path: str) -> tuple[dict, np.ndarray, np.ndarray | None]:
    """The header, the (H, W, C) uint8 pixels and the palette of a PNG."""
    header, raw, palette = read_png(path)
    h, rowbytes, c = _raw_rows(path, header, raw)
    px = np.empty(h * rowbytes, np.uint8)
    src = np.frombuffer(raw, np.uint8)
    err = library().sfi_unfilter(src.ctypes.data, px.ctypes.data, h, rowbytes, c)
    if err:
        raise PNGError(f"{path}: row {err - 1} has an unknown filter type")
    return header, px.reshape(h, header["width"], c), palette


def imread(path: str) -> np.ndarray:
    """``np.array(PIL.Image.open(path))`` for an 8-bit PNG: (H, W) for gray
    and palette (indices), else (H, W, C) uint8."""
    _, px, _ = decode(path)
    return px[..., 0] if px.shape[2] == 1 else px


def to_rgb(path: str) -> np.ndarray:
    """PIL's ``convert("RGB")`` of the file: (H, W, 3) uint8 (alpha dropped,
    gray repeated, a palette looked up)."""
    header, px, palette = decode(path)
    if header["color"] == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[px[..., 0]]
    if header["color"] in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PIL's BILINEAR resize of a uint8 (H, W, C) array."""
    a = np.ascontiguousarray(img, np.uint8)
    h, w, c = a.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    if library().sfi_resize_bilinear(a.ctypes.data, h, w, c, out.ctypes.data, out_h, out_w):
        raise ValueError(f"resize of {a.shape} to {(out_h, out_w)}")
    return out


def decode_resize_batch(paths, out_h: int, out_w: int) -> np.ndarray:
    """(N, out_h, out_w, 3) float32 in [0, 1]: each file in RGB, resized
    with PIL's BILINEAR, divided by 255."""
    out = np.empty((len(paths), out_h, out_w, 3), np.float32)
    for i, path in enumerate(paths):
        out[i] = resize_bilinear(to_rgb(path), out_h, out_w) / np.float32(255)
    return out


# ---------------------------------------------------------------------------
# the plain versions (numpy), for the tests
# ---------------------------------------------------------------------------


def unfilter_plain(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """``sfi_unfilter`` in numpy: (h, rowbytes) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, rowbytes + 1)
    out = np.zeros((h, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.int64)
    for y in range(h):
        ft, src = rows[y, 0], rows[y, 1:].astype(np.int64)
        cur = np.zeros(rowbytes + bpp, np.int64)  # bpp leading zeros: the left of the row
        if ft == 0:
            cur[bpp:] = src
        elif ft == 2:
            cur[bpp:] = (src + prior) & 255
        elif ft == 1:
            cur[bpp:] = np.cumsum(src.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ft in (3, 4):
            up = np.concatenate([np.zeros(bpp, np.int64), prior])
            for x in range(0, rowbytes, bpp):
                a, b, c = cur[x:x + bpp], up[x + bpp:x + 2 * bpp], up[x:x + bpp]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x + bpp:x + 2 * bpp] = (src[x:x + bpp] + pred) & 255
        else:
            raise PNGError(f"row {y} has an unknown filter type {ft}")
        out[y] = cur[bpp:]
        prior = cur[bpp:]
    return out


def _coeffs(in_size: int, out_size: int) -> tuple[list, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for BILINEAR."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds, kk = [], np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale)) for x in range(xmax)]
        ww = sum(k)
        for x in range(xmax):
            v = (k[x] / ww if ww != 0.0 else k[x]) * (1 << 22)
            kk[xx, x] = int(v - 0.5) if v < 0 else int(v + 0.5)
        bounds.append((xmin, xmax))
    return bounds, kk


def _pass(a: np.ndarray, out_size: int) -> np.ndarray:
    """One resampling pass along axis 0 of an (n, ...) uint8 array."""
    bounds, kk = _coeffs(a.shape[0], out_size)
    out = np.empty((out_size,) + a.shape[1:], np.uint8)
    for i, (xmin, xmax) in enumerate(bounds):
        acc = (1 << 21) + np.tensordot(kk[i, :xmax], a[xmin:xmin + xmax].astype(np.int64), 1)
        out[i] = np.where(acc >= 1 << 30, 255, np.where(acc <= 0, 0, acc >> 22))
    return out


def resize_plain(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``resize_bilinear`` in numpy (horizontal, then vertical, uint8 between)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    out = img
    if w != out_w:
        out = _pass(out.swapaxes(0, 1), out_w).swapaxes(0, 1)
    if h != out_h:
        out = _pass(out, out_h)
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, array: np.ndarray, level: int = 6) -> None:
    """An 8-bit PNG of a (H, W) gray or (H, W, C) uint8 array, C in 1-4
    (gray, gray + alpha, RGB, RGBA): filter 0 on every row, one IDAT."""
    a = np.ascontiguousarray(array, np.uint8)
    c = 1 if a.ndim == 2 else a.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = a.reshape(h, w * c)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
