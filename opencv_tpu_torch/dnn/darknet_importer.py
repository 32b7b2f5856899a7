"""Darknet importer -> dnn.Net, YOLO-family .cfg + .weights (port of
opencv_tpu/dnn/darknet_importer.py; the reference's modules/dnn/src/darknet/).

The .cfg is an INI-style layer list; .weights is a raw float32 stream
(header: 3 x int32 version + the seen counter, int64 when
major*10 + minor >= 2, then per-layer parameters in file order:
convolutional with batch_normalize: biases, bn scales, rolling means,
rolling variances, then kernels OIHW; plain convolutional: biases then
kernels; connected: biases then weights).

Sections: net, convolutional (leaky/linear/relu/logistic/mish,
batch_normalize, pad/stride), maxpool, avgpool, upsample, route,
shortcut, connected, softmax, region (YOLO v2 head), yolo (v3 head). NCHW.
`[maxpool]` is VALID as in the JAX package (a size-2 stride-1 pool
shrinks the map by one where darknet pads).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from opencv_tpu_torch.dnn import layers
from opencv_tpu_torch.dnn.net import Net


def parse_cfg(text: str) -> list[dict]:
    """[{'type': ..., key: value, ...}, ...] in file order."""
    sections: list[dict] = []
    cur: dict | None = None
    for raw in text.splitlines():
        line = raw.split("#")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            cur = {"type": line.strip("[]").strip()}
            sections.append(cur)
        elif "=" in line and cur is not None:
            k, v = line.split("=", 1)
            cur[k.strip()] = v.strip()
    return sections


class _WeightReader:
    def __init__(self, buf: bytes):
        major, minor, _rev = struct.unpack("<3i", buf[:12])
        off = 12 + (8 if major * 10 + minor >= 2 else 4)  # seen counter
        self.data = np.frombuffer(buf[off:], np.float32)
        self.pos = 0

    def take(self, n: int) -> np.ndarray:
        out = self.data[self.pos:self.pos + n]
        if out.size != n:
            raise ValueError("weights file exhausted")
        self.pos += n
        return np.array(out)


def _leaky(x):
    return torch.where(x > 0, x, 0.1 * x)


def _mish(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def _act(name: str):
    if name in ("linear", "", None):
        return None
    acts = {"leaky": _leaky, "relu": layers.relu, "logistic": layers.sigmoid, "mish": _mish}
    if name not in acts:
        raise NotImplementedError(f"darknet activation {name!r}")
    return acts[name]


def _anchors(text: str) -> np.ndarray:
    return np.asarray([float(v) for v in text.replace(" ", ",").split(",") if v],
                      np.float32).reshape(-1, 2)


def load_darknet(cfg_text: str, weights=None, in_channels: int | None = None,
                 device=None) -> Net:
    """Build a Net from cfg text (+ optional .weights bytes or path)
    (readNetFromDarknet analog). Input layer name: 'data' (NCHW). The
    weights go to the card unless `device="cpu"`."""
    if isinstance(weights, str):
        with open(weights, "rb") as f:
            weights = f.read()
    reader = _WeightReader(weights) if weights is not None else None
    sections = parse_cfg(cfg_text)
    assert sections and sections[0]["type"] in ("net", "network")
    net_cfg = sections[0]
    net = Net(device)
    net._input_names = ["data"]
    names: list[str] = ["data"]  # output name of each darknet layer index - 1
    chans: list[int] = [in_channels or int(net_cfg.get("channels", 3))]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=net.device)

    def prev(i_rel: int) -> str:
        # darknet route indices: negative = relative, >= 0 = absolute layer
        return names[i_rel + 1] if i_rel >= 0 else names[i_rel]

    def chan(i_rel: int) -> int:
        return chans[i_rel + 1] if i_rel >= 0 else chans[i_rel]

    for li, sec in enumerate(sections[1:]):
        kind = sec["type"]
        name = f"l{li}_{kind}"
        ins = [names[-1]]
        if kind == "convolutional":
            n = int(sec["filters"])
            size = int(sec.get("size", 1))
            stride = int(sec.get("stride", 1))
            pad = (size // 2) if int(sec.get("pad", 0)) else int(sec.get("padding", 0))
            bn = int(sec.get("batch_normalize", 0))
            c_in = chans[-1]
            if reader is not None:
                bias = reader.take(n)
                if bn:
                    scale, mean, var = reader.take(n), reader.take(n), reader.take(n)
                kern = reader.take(n * c_in * size * size).reshape(n, c_in, size, size)
            else:
                bias, kern = np.zeros(n), np.zeros((n, c_in, size, size))
                scale, mean, var = np.ones(n), np.zeros(n), np.ones(n)
            act = _act(sec.get("activation", "linear"))
            pads = [(pad, pad), (pad, pad)]
            if bn:
                def fn(x, k=t(kern), b=t(bias), s=t(scale), m=t(mean), v=t(var), stride=stride,
                       pads=pads, act=act):
                    out = layers.batch_norm(layers.convolution(x, k, None, stride, pads), m, v, s, b,
                                            eps=1e-5)
                    return act(out) if act else out
            else:
                def fn(x, k=t(kern), b=t(bias), stride=stride, pads=pads, act=act):
                    out = layers.convolution(x, k, b, stride, pads)
                    return act(out) if act else out
            chans.append(n)
        elif kind == "maxpool":
            size = int(sec.get("size", 2))
            stride = int(sec.get("stride", size))

            def fn(x, size=size, stride=stride):
                return layers.max_pool(x, size, stride)
            chans.append(chans[-1])
        elif kind == "avgpool":
            def fn(x):
                return x.mean(dim=(2, 3))
            chans.append(chans[-1])
        elif kind == "upsample":
            stride = int(sec.get("stride", 2))

            def fn(x, s=stride):
                return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            chans.append(chans[-1])
        elif kind == "route":
            idxs = [int(v) for v in sec["layers"].split(",")]
            ins = [prev(i) for i in idxs]

            def fn(*xs):
                return xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
            chans.append(sum(chan(i) for i in idxs))
        elif kind == "shortcut":
            act = _act(sec.get("activation", "linear"))
            ins = [names[-1], prev(int(sec["from"]))]

            def fn(a, b, act=act):
                return act(a + b) if act else a + b
            chans.append(chans[-1])
        elif kind == "connected":
            n = int(sec["output"])
            act = _act(sec.get("activation", "linear"))
            if reader is not None:
                bias = reader.take(n)
                if "inputs" in sec:
                    c_in = int(sec["inputs"])
                elif li == len(sections) - 2:  # the last layer: the rest of the stream
                    c_in = (reader.data.size - reader.pos) // n
                else:
                    raise NotImplementedError("connected layer needs 'inputs=' unless last")
                w = reader.take(n * c_in).reshape(n, c_in)  # darknet stores [out, in]
            else:
                c_in = int(sec.get("inputs", 1))
                bias, w = np.zeros(n), np.zeros((n, c_in))

            def fn(x, w=t(w), b=t(bias), act=act):
                out = layers.fully_connected(x, w, b)
                return act(out) if act else out
            chans.append(n)
        elif kind == "softmax":
            def fn(x):
                return torch.softmax(x, dim=-1)
            chans.append(chans[-1])
        elif kind == "region":
            # YOLO v2 head: anchors in GRID units, softmax classes
            classes = int(sec.get("classes", 20))
            num = int(sec.get("num", 5))
            anchors = t(_anchors(sec.get("anchors", ",".join(["1,1"] * num)))[:num])

            def fn(x, a=anchors, classes=classes, th=float(sec.get("thresh", 0.2)),
                   sm=int(sec.get("softmax", 0)) == 1):
                return layers.region_decode(x, a, classes, use_softmax=sm, thresh=th)
            chans.append(5 + classes)
        elif kind == "yolo":
            # YOLO v3 head: the `mask` subset of anchors, in NET-INPUT pixels, logistic classes
            classes = int(sec.get("classes", 80))
            mask = [int(v) for v in str(sec.get("mask", "0,1,2")).split(",")]
            anchors = t(_anchors(sec["anchors"])[mask])
            wh = (float(net_cfg.get("width", 416)), float(net_cfg.get("height", 416)))

            def fn(x, a=anchors, classes=classes, th=float(sec.get("thresh", 0.2)), wh=wh):
                return layers.region_decode(x, a, classes, use_softmax=False, thresh=th, wh_norm=wh)
            chans.append(5 + classes)
        else:
            raise NotImplementedError(f"darknet section {kind!r}")
        net.add_layer(name, fn, ins)
        names.append(name)
    return net
