"""QR code round trip (port of examples/qr_demo.py, the objdetect
QRCodeDetector analog): encode a message, render it into a noisy scene,
detect and decode it.

    python -m opencv_tpu_torch.examples.qr_demo [--cpu] [--text "..."]

The code is version 2 with 5-px modules at (90, 70) of a 300x340 grey
scene with N(0, 6) noise (seed 0). Exits 0 when the decoded text is the
message.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import qrcode


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m opencv_tpu_torch.examples.qr_demo",
                                 description="QR encode, render, detect and decode.")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--text", default="opencv_tpu says hi")
    return ap


def scene(text: str) -> np.ndarray:
    """The code of `text` in a noisy 300x340 scene, f32."""
    img = qrcode.render_qr(qrcode.encode_qr(text, version=2), module_px=5)
    rng = np.random.default_rng(0)
    out = np.full((300, 340), 190.0, np.float32)
    out[70:70 + img.shape[0], 90:90 + img.shape[1]] = img
    out += rng.normal(0, 6.0, out.shape).astype(np.float32)
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    img = torch.from_numpy(scene(args.text)).to(dev)
    quad, detected = qrcode.detect_qr(img, device=dev)
    print("detected:", detected, "quad:\n", np.round(quad, 1))
    text = qrcode.decode_qr(img, quad, device=dev)
    print("decoded:", repr(text))
    ok = text == args.text
    print("round trip OK" if ok else "round trip failed")
    return dict(detected=bool(detected), quad=np.asarray(quad).tolist(), text=text, ok=ok)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
