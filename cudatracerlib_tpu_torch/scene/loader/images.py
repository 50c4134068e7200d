"""Image loading for textures and environment maps (host side, numpy).

Port of ``cudatracerlib_tpu/scene/loader/images.py``: a pure-numpy Radiance
.hdr (RGBE) reader and writer, PIL for the LDR formats (decoded sRGB ->
linear) and EXR through imageio or cv2. Only .hdr needs numpy alone; PIL,
imageio and cv2 are imported when a file of their format is loaded, so a
machine without them loads .hdr files and nothing else.
"""
from __future__ import annotations

import os

import numpy as np


def load_image(path: str, gamma: bool = True) -> np.ndarray:
    """Load an image as (H, W, 3) float32 linear RGB."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return load_hdr(path)
    if ext == ".exr":
        return _load_exr(path)
    from PIL import Image
    img = Image.open(path).convert("RGB")
    arr = np.asarray(img, np.float32) / 255.0
    if gamma:
        arr = np.where(arr <= 0.04045, arr / 12.92,
                       np.power(np.maximum((arr + 0.055) / 1.055, 0.0), 2.4))
    return arr.astype(np.float32)


def _load_exr(path: str) -> np.ndarray:
    try:
        import imageio.v3 as iio
        arr = np.asarray(iio.imread(path), np.float32)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, -1)
        return arr[..., :3]
    except Exception:
        try:
            import cv2  # pragma: no cover
            arr = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32)
            return arr[..., 2::-1]
        except Exception:
            raise IOError(f"cannot decode EXR {path}; convert to .hdr")


def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) reader with RLE support."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at blank line; next line is resolution
    pos = 0
    if not data.startswith(b"#?"):
        raise IOError("not a Radiance file")
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    assert res[0] == b"-Y" and res[2] == b"+X", f"unsupported orientation {res}"
    H, W = int(res[1]), int(res[3])

    rgbe = np.zeros((H, W, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, len(data) - pos, pos)
    bi = 0
    for y in range(H):
        if W < 8 or W > 0x7FFF or buf[bi] != 2 or buf[bi + 1] != 2:
            # flat (non-RLE) scanline
            row = buf[bi:bi + W * 4].reshape(W, 4)
            rgbe[y] = row
            bi += W * 4
            continue
        assert (int(buf[bi + 2]) << 8 | int(buf[bi + 3])) == W
        bi += 4
        for c in range(4):
            x = 0
            while x < W:
                count = int(buf[bi]); bi += 1
                if count > 128:  # run
                    rgbe[y, x:x + count - 128, c] = buf[bi]
                    bi += 1
                    x += count - 128
                else:  # literal
                    rgbe[y, x:x + count, c] = buf[bi:bi + count]
                    bi += count
                    x += count
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def write_hdr(path: str, img: np.ndarray):
    """Minimal flat (non-RLE) Radiance writer for golden images."""
    H, W = img.shape[:2]
    m = np.maximum(img.max(-1), 1e-32)
    e = np.ceil(np.log2(m)).astype(np.int32) + 1
    scale = np.ldexp(1.0, -e + 8)
    rgbe = np.zeros((H, W, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.clip(e + 128, 0, 255).astype(np.uint8)
    zero = img.max(-1) < 1e-32
    rgbe[zero] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {H} +X {W}\n".encode())
        f.write(rgbe.tobytes())
