"""16-bit greyscale PNG: the depth images of the on-disk datasets.

The JAX package decodes them through its native runtime (libpng) or PIL
(``xslam_tpu/io/dataset.py::_read_depth_png``) and writes them with PIL
(``apps/make_realistic_dataset.py``); the port reads and writes them with
the standard library's ``zlib`` and ``struct`` and numpy, so it needs
neither.

Read: 16-bit greyscale (colour type 0), not interlaced, every row filter of
the PNG specification (None, Sub, Up, Average, Paeth: an encoder such as
PIL's picks one a row). Sub and Up are vectorised over the row; Average and
Paeth read the byte just reconstructed to their left, so they run as a
plain loop over the row's bytes (``python -m xslam_tpu_torch.io.png``
times a 640x480 image of Paeth rows against one of None rows). Any other
colour type, bit depth or interlace raises, naming the file.

Write: every row with filter None, all in one IDAT chunk.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
BYTES_PER_PIXEL = 2  # 16-bit greyscale


def _chunks(data: bytes, path: str):
    """``(type, payload)`` of each chunk, CRCs checked."""
    at = len(SIGNATURE)
    while at + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[at:at + 8])
        payload = data[at + 8:at + 8 + length]
        (crc,) = struct.unpack(">I", data[at + 8 + length:at + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC in a {kind.decode('latin-1')} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        at += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray, path: str) -> np.ndarray:
    """One reconstructed row (uint8) from its filtered bytes and the
    reconstructed row above (zeros above the first)."""
    bpp = BYTES_PER_PIXEL
    if kind == 0:
        return row
    if kind == 1:  # Sub: a running sum mod 256 over each byte lane of the pixels
        return (np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if kind == 2:  # Up
        return row + prior  # uint8 arithmetic wraps mod 256
    if kind not in (3, 4):
        raise ValueError(f"{path}: unknown PNG row filter {kind}")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:  # Average
            pred = (a + up[i]) >> 1
        else:  # Paeth
            pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png16(path: str) -> np.ndarray:
    """A 16-bit greyscale PNG as a C-contiguous (H, W) uint16 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, colour, _, _, interlace = header
    if depth != 16 or colour != 0 or interlace != 0:
        raise ValueError(f"{path}: expected a 16-bit greyscale PNG without interlace, got bit depth {depth}, "
                         f"colour type {colour}, interlace {interlace}")
    stride = W * BYTES_PER_PIXEL
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {H} rows of {W} pixels")
    rows = raw.reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, path)
    return out.view(">u2").astype(np.uint16)


def _filter_rows(raw: np.ndarray, filters: Sequence[int]) -> np.ndarray:
    """Each row of ``raw`` ((H, stride) uint8) filtered by its entry of
    ``filters``, its filter byte first: (H, stride + 1) uint8. The filters
    read the unfiltered bytes only, so each is one numpy expression."""
    bpp = BYTES_PER_PIXEL
    H, stride = raw.shape
    x = raw.astype(np.int64)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: paeth}
    out = np.empty((H, stride + 1), np.uint8)
    for y, kind in enumerate(filters):
        if kind not in preds:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y, 0] = kind
        pred = preds[kind]
        out[y, 1:] = (x[y] - (pred if np.isscalar(pred) else pred[y])) & 0xFF
    return out


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))


def encode_png16(arr: np.ndarray, filters: Optional[Sequence[int]] = None) -> bytes:
    """The bytes of a 16-bit greyscale PNG of ``arr`` ((H, W), values taken
    as uint16), one IDAT chunk; row y filtered by ``filters[y]`` (None: every
    row with filter None)."""
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got shape {arr.shape}")
    H, W = arr.shape
    raw = np.ascontiguousarray(arr.astype(">u2")).view(np.uint8).reshape(H, W * BYTES_PER_PIXEL)
    rows = _filter_rows(raw, [0] * H if filters is None else filters)
    header = struct.pack(">IIBBBBB", W, H, 16, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png16(path: str, arr: np.ndarray) -> None:
    """Write ``arr`` ((H, W) uint16) as a 16-bit greyscale PNG, rows with
    filter None."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint16:
        raise TypeError(f"{path}: expected uint16 pixels, got {arr.dtype}")
    with open(path, "wb") as f:
        f.write(encode_png16(arr))


def main() -> None:
    """Time the host's decode of a 640x480 rendered depth image written with
    every row filtered by Paeth, and with every row by None."""
    import os
    import tempfile
    import time

    from ..geometry.intrinsics import ICL_INTRINSICS
    from .synthetic import cluttered_scene, handheld_trajectory, render_depth

    d_mm = render_depth(cluttered_scene(), handheld_trajectory(2, seed=11)[0], ICL_INTRINSICS)
    depth = np.clip(d_mm.astype(np.uint32) * 5, 0, 65535).astype(np.uint16)  # the ICL files' factor
    with tempfile.TemporaryDirectory() as tmp:
        for name, kind in (("paeth", 4), ("none", 0)):
            path = os.path.join(tmp, f"{name}.png")
            with open(path, "wb") as f:
                f.write(encode_png16(depth, [kind] * depth.shape[0]))
            t0 = time.perf_counter()
            back = read_png16(path)
            ms = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(back, depth):
                raise RuntimeError(f"the {name} image did not decode to its pixels")
            print(f"decode 640x480, every row {name}: {ms:.1f} ms (host CPU)")


if __name__ == "__main__":
    main()
