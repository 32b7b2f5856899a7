"""Image I/O (imgcodecs analog; port of opencv_tpu/io/image.py).

Host code, as in the JAX package: images come back as numpy f32
grayscale [H, W] (or RGB [H, W, 3]) for the caller to upload. Binary
PGM/PPM go through `_read_pnm`; baseline one-component JPEG goes through
the port's own decoder (`io/_jpeg.py`, PIL's bytes without PIL); PNG,
colour JPEG and anything else the decoder does not take go through PIL,
imported when needed, exactly as the JAX package reads them.
"""

from __future__ import annotations

import os

import numpy as np

from opencv_tpu_torch.io import _jpeg

_GRAY_WEIGHTS = np.array([0.299, 0.587, 0.114], np.float32)


def _read_jpeg_gray(path: str) -> np.ndarray | None:
    """u8 [H, W] of a baseline one-component JPEG, or None for a file the
    port's decoder does not take."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _jpeg.decode(data)
    except _jpeg.Unsupported:
        return None


def imread(path: str, grayscale: bool = True) -> np.ndarray:
    """Read an image file -> f32 [H,W] (grayscale) or [H,W,3] RGB.
    (cv::imread analog, modules/imgcodecs/src/loadsave.cpp.)

    A gray JPEG takes the JAX package's steps after PIL's decode:
    `convert("RGB")` copies the one channel three times, and the f32
    weighting below follows, so the values equal JAX's even where the
    three weights do not sum to exactly 1 in f32."""
    ext = os.path.splitext(path)[1].lower()
    arr = None
    if ext in (".pgm", ".ppm", ".pnm"):
        arr = _read_pnm(path)
    elif ext in (".jpg", ".jpeg"):
        gray = _read_jpeg_gray(path)
        if gray is not None:
            arr = np.repeat(gray[:, :, None], 3, axis=2).astype(np.float32)
    if arr is None:
        from PIL import Image

        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.float32)
    if grayscale and arr.ndim == 3:
        arr = arr @ _GRAY_WEIGHTS
    return arr.astype(np.float32)


def imwrite(path: str, img: np.ndarray) -> None:
    """Write an image (u8 conversion with clipping) through PIL."""
    from PIL import Image

    arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def _read_pnm(path: str) -> np.ndarray:
    """Minimal binary PGM (P5) / PPM (P6) reader (KITTI ships PNG, TUM
    PGM depth; keeps io importable without PIL)."""
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval separated by whitespace/comments
    tokens: list[bytes] = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    if magic == b"P5":
        arr = np.frombuffer(data, dtype, count=w * h, offset=i).reshape(h, w)
    elif magic == b"P6":
        arr = np.frombuffer(data, dtype, count=w * h * 3, offset=i).reshape(h, w, 3)
    else:
        raise ValueError(f"unsupported PNM magic {magic!r}")
    return arr.astype(np.float32)
