"""Video I/O (port of opencv_tpu/io/video.py): Y4M (uncompressed
YUV4MPEG2) and MJPEG-AVI read/write, plus a VideoCapture/VideoWriter
facade over files, image folders and printf or glob patterns.

Reference: modules/videoio (cap_mjpeg_decoder.cpp and
cap_mjpeg_encoder.cpp are its in-tree no-dependency pair;
cap_images.cpp is image-sequence input, the mode the fork's TBD sample
uses, samples/gpu/tbd.cpp --folder).

Host numpy, as in the JAX package: the readers return numpy frames, and
the engine's entry points upload them. A frame of an MJPEG-AVI is
decoded by the port's baseline decoder (`io/_jpeg.py`), which gives
PIL's bytes on the files it takes, so the committed clip decodes
without PIL; a chunk it does not take (progressive, colour, ...) goes to
PIL, as every chunk does in the JAX package. Encoding stays with PIL,
imported when needed.
"""

from __future__ import annotations

import glob
import io as _io
import os
import struct

import numpy as np

from opencv_tpu_torch.io import _jpeg
from opencv_tpu_torch.io.image import imread


# ------------------------------------------------------------- Y4M -----

def write_y4m(path: str, frames: np.ndarray, fps: int = 25) -> None:
    """frames: [T, H, W] u8/f32 grayscale -> YUV4MPEG2 mono file."""
    frames = np.clip(np.asarray(frames), 0, 255).astype(np.uint8)
    t, h, w = frames.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 Cmono\n".encode())
        for k in range(t):
            f.write(b"FRAME\n")
            f.write(frames[k].tobytes())


def read_y4m(path: str) -> tuple[np.ndarray, int]:
    """-> (frames [T, H, W] u8, fps). Supports Cmono and C420*."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            header += f.read(1)
        fields = header.decode().split()
        w = h = fps = 0
        color = "420"
        for tok in fields[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "F":
                fps = int(tok[1:].split(":")[0])
            elif tok[0] == "C":
                color = tok[1:]
        ysize = w * h
        csize = 0 if color.startswith("mono") else (w // 2) * (h // 2) * 2
        frames = []
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("bad Y4M frame marker")
            y = np.frombuffer(f.read(ysize), np.uint8).reshape(h, w)
            if csize:
                f.read(csize)  # luma only: the engine is grayscale-first
            frames.append(y)
    return np.stack(frames), fps


# ------------------------------------------------------ MJPEG in AVI ---

def _jpeg_encode(frame: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=quality
    )
    return buf.getvalue()


def _jpeg_decode(data: bytes) -> np.ndarray:
    """One JPEG chunk -> u8 [H, W] grayscale: the port's decoder, or PIL's
    `convert("L")` for a file that the decoder does not take."""
    try:
        return _jpeg.decode(data)
    except _jpeg.Unsupported:
        from PIL import Image

        img = Image.open(_io.BytesIO(data)).convert("L")
        return np.asarray(img, np.uint8)


def write_mjpeg_avi(
    path: str, frames: np.ndarray, fps: int = 25, quality: int = 90
) -> None:
    """Minimal MJPEG AVI writer (cap_mjpeg_encoder.cpp analog)."""
    frames = np.asarray(frames)
    t, h, w = frames.shape[:3]
    chunks = [_jpeg_encode(f, quality) for f in frames]

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    # stream header
    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh",
        b"vids", b"MJPG", 0, 0, 0, 0, 1, fps, 0, t, 0, 0xFFFFFFFF, 0,
        0, 0, w, h,
    )
    bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                      w * h * 3, 0, 0, 0, 0)
    strl = b"LIST" + struct.pack(
        "<I", 4 + len(chunk(b"strh", strh)) + len(chunk(b"strf", bih))
    ) + b"strl" + chunk(b"strh", strh) + chunk(b"strf", bih)
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        1000000 // fps, 0, 0, 0x10, t, 0, 1, 0, w, h, 0, 0, 0, 0,
    )
    hdrl = b"LIST" + struct.pack(
        "<I", 4 + len(chunk(b"avih", avih)) + len(strl)
    ) + b"hdrl" + chunk(b"avih", avih) + strl

    movi_body = b"".join(chunk(b"00dc", c) for c in chunks)
    movi = b"LIST" + struct.pack("<I", 4 + len(movi_body)) + b"movi" + movi_body
    riff_body = b"AVI " + hdrl + movi
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)


def read_mjpeg_avi(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode every 00dc/00db JPEG chunk (cap_mjpeg_decoder.cpp analog),
    or only the first `max_frames`. Returns [T, H, W] u8 grayscale."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    frames = []

    def walk(buf: bytes):
        pos = 0
        while pos + 8 <= len(buf):
            fourcc = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            payload = buf[pos + 8:pos + 8 + size]
            if fourcc == b"LIST":
                walk(payload[4:])
            elif fourcc in (b"00dc", b"00db") and size > 2:
                if max_frames is None or len(frames) < max_frames:
                    frames.append(_jpeg_decode(payload))
            pos += 8 + size + (size % 2)

    walk(data[12:])
    return np.stack(frames)


# ----------------------------------------------------------- facades ---

class VideoCapture:
    """cv::VideoCapture analog over .y4m / MJPEG .avi / image folders or
    glob patterns (the backends of videoio the engine actually needs)."""

    def __init__(self, source: str):
        self._frames: np.ndarray | None = None
        self._paths: list[str] | None = None
        self.fps = 25
        if source.endswith(".y4m"):
            self._frames, self.fps = read_y4m(source)
        elif source.endswith(".avi"):
            self._frames = read_mjpeg_avi(source)
        elif os.path.isdir(source):
            self._paths = sorted(
                glob.glob(os.path.join(source, "*.png"))
                + glob.glob(os.path.join(source, "*.jpg"))
                + glob.glob(os.path.join(source, "*.pgm"))
            )
        elif any(ch in source for ch in "*?%"):
            if "%" in source:  # printf-style sequence (cap_images.cpp)
                self._paths = []
                i = 0
                while os.path.exists(source % i):
                    self._paths.append(source % i)
                    i += 1
            else:
                self._paths = sorted(glob.glob(source))
        else:
            raise ValueError(f"unsupported source {source!r}")
        self._pos = 0

    def is_opened(self) -> bool:
        return (self._frames is not None and len(self._frames) > 0) or bool(
            self._paths
        )

    def frame_count(self) -> int:
        if self._frames is not None:
            return len(self._frames)
        return len(self._paths or [])

    def read(self) -> tuple[bool, np.ndarray | None]:
        if self._frames is not None:
            if self._pos >= len(self._frames):
                return False, None
            f = self._frames[self._pos]
        else:
            if self._pos >= len(self._paths):
                return False, None
            f = imread(self._paths[self._pos])
        self._pos += 1
        return True, np.asarray(f, np.float32)


class VideoWriter:
    """cv::VideoWriter analog: .y4m (raw) or .avi (MJPEG) by extension."""

    def __init__(self, path: str, fps: int = 25, quality: int = 90):
        self.path = path
        self.fps = fps
        self.quality = quality
        self._frames: list[np.ndarray] = []

    def write(self, frame: np.ndarray) -> None:
        self._frames.append(np.asarray(frame))

    def release(self) -> None:
        frames = np.stack(self._frames)
        if self.path.endswith(".y4m"):
            write_y4m(self.path, frames, self.fps)
        elif self.path.endswith(".avi"):
            write_mjpeg_avi(self.path, frames, self.fps, self.quality)
        else:
            raise ValueError(f"unsupported extension {self.path!r}")
