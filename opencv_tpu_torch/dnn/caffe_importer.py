"""Caffe model importer -> dnn.Net (port of opencv_tpu/dnn/caffe_importer.py;
the reference's modules/dnn/src/caffe/caffe_importer.cpp).

Handles the deploy-style pair: a .prototxt (protobuf TEXT format, parsed
by the small recursive parser below) describing the topology, and a
binary .caffemodel carrying the learned blobs. Field numbers from the
public Caffe schema: NetParameter.name=1/.input=3/.input_dim=4/.layer=100;
LayerParameter.name=1/.type=2/.bottom=3/.top=4/.blobs=7; BlobProto.data=5
(packed float)/.shape=7; BlobShape.dim=1. Pooling takes the ONNX
importer's `_pool` (floor output size, real-cell averages), as the JAX
importer does.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.dnn import layers, proto
from opencv_tpu_torch.dnn.net import Net
from opencv_tpu_torch.dnn.onnx_importer import _pool


# ---------------------------------------------------- prototxt parsing ---

def parse_prototxt(text: str) -> dict:
    """Protobuf text format -> nested dict; repeated keys become lists."""
    tokens = []
    for raw in text.splitlines():
        line = raw.split("#")[0].strip()
        if line:
            tokens.extend(line.replace("{", " { ").replace("}", " } ").replace(":", ": ").split())

    def scalar(v: str):
        if v.startswith('"'):
            return v.strip('"')
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        return v.strip('"')

    def parse_block(i):
        out: dict = {}
        while i < len(tokens):
            t = tokens[i]
            if t == "}":
                return out, i + 1
            key = t.rstrip(":")
            if i + 1 < len(tokens) and tokens[i + 1] == "{":
                val, i = parse_block(i + 2)
            else:
                val, i = scalar(tokens[i + 1]), i + 2
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(val)
            else:
                out[key] = val
        return out, i

    return parse_block(0)[0]


def _aslist(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# ------------------------------------------------------- binary blobs ---

def _blob(fields) -> np.ndarray:
    data = np.asarray(proto.get_floats_packed(fields, 5), np.float32)
    if 7 in fields:
        shape = proto.get_ints(proto.parse(fields[7][-1]), 1)
    else:  # legacy num/channels/height/width
        shape = [proto.get_int(fields, k, 1) for k in (1, 2, 3, 4)]
    return data.reshape([int(s) for s in shape])


def load_caffemodel_blobs(path_or_bytes) -> dict[str, list[np.ndarray]]:
    """layer name -> blobs of a binary .caffemodel."""
    if isinstance(path_or_bytes, str):
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    else:
        buf = bytes(path_or_bytes)
    return {proto.get_str(lf, 1): [_blob(b) for b in proto.get_messages(lf, 7)]
            for lf in proto.get_messages(proto.parse(buf), 100)}


# ------------------------------------------------------------ importer ---

def load_caffe(prototxt_text: str, caffemodel=None, device=None) -> Net:
    """Build a Net from deploy prototxt (+ optional binary weights)
    (readNetFromCaffe analog). The weights go to the card unless
    `device="cpu"`."""
    cfg = parse_prototxt(prototxt_text)
    blobs = load_caffemodel_blobs(caffemodel) if caffemodel is not None else {}
    net = Net(device)
    inputs = _aslist(cfg.get("input")) or ["data"]
    net._input_names = list(inputs)
    # Caffe names BLOBS, and in-place layers reuse the producer's blob name:
    # resolve every bottom through the latest producer of that blob
    blob_to_layer = {i: i for i in inputs}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=net.device)

    for layer_cfg in _aslist(cfg.get("layer")):
        name, ltype = layer_cfg["name"], layer_cfg["type"]
        bottoms = _aslist(layer_cfg.get("bottom"))
        wb = blobs.get(name, [])
        weight = t(wb[0]) if len(wb) > 0 else None
        bias = t(wb[1]) if len(wb) > 1 else None
        if ltype == "Input":
            continue
        if ltype == "Convolution":
            p = layer_cfg.get("convolution_param", {})
            stride, pad = int(p.get("stride", 1)), int(p.get("pad", 0))
            groups = int(p.get("group", 1))

            def fn(x, weight=weight, bias=bias, stride=stride, pad=pad, groups=groups):
                return layers.convolution(x, weight, bias, stride, [(pad, pad), (pad, pad)], groups)
        elif ltype == "InnerProduct":
            def fn(x, weight=weight, bias=bias):
                return layers.fully_connected(x, weight, bias)
        elif ltype == "ReLU":
            fn = layers.relu
        elif ltype == "Sigmoid":
            fn = layers.sigmoid
        elif ltype == "TanH":
            fn = torch.tanh
        elif ltype == "Softmax":
            fn = layers.softmax
        elif ltype == "Pooling":
            p = layer_cfg.get("pooling_param", {})
            k = int(p.get("kernel_size", 2))
            stride, pad = int(p.get("stride", k)), int(p.get("pad", 0))
            is_max = p.get("pool", "MAX") in ("MAX", 0)
            if p.get("global_pooling", "false") in (True, "true", 1):
                def fn(x, is_max=is_max):
                    return x.amax(dim=(2, 3), keepdim=True) if is_max else x.mean(dim=(2, 3), keepdim=True)
            else:
                def fn(x, k=k, stride=stride, pad=pad, mode="max" if is_max else "avg"):
                    return _pool(x, (k, k), (stride, stride), [(pad, pad), (pad, pad)], mode)
        elif ltype == "Eltwise":
            op = layer_cfg.get("eltwise_param", {}).get("operation", "SUM")
            fn = torch.add if op in ("SUM", 1) else torch.mul
        elif ltype == "Concat":
            axis = int(layer_cfg.get("concat_param", {}).get("axis", 1))

            def fn(*xs, axis=axis):
                return torch.cat(xs, dim=axis)
        elif ltype == "Flatten":
            fn = layers.flatten
        elif ltype == "BatchNorm":
            scale = float(wb[2].reshape(-1)[0]) if len(wb) > 2 else 1.0
            scale = 1.0 / scale if scale != 0 else 1.0
            mean, var = t(wb[0]) * scale, t(wb[1]) * scale

            def fn(x, mean=mean, var=var):
                return layers.batch_norm(x, mean, var, torch.ones_like(mean), torch.zeros_like(mean))
        elif ltype == "Scale":
            gamma = weight
            beta = bias if bias is not None else torch.zeros_like(gamma)

            def fn(x, gamma=gamma, beta=beta):
                return x * gamma.reshape(1, -1, 1, 1) + beta.reshape(1, -1, 1, 1)
        elif ltype == "Dropout":
            def fn(x):
                return x
        else:
            raise NotImplementedError(f"Caffe layer type {ltype!r}")
        net.add_layer(name, fn, [blob_to_layer.get(b, b) for b in bottoms] if bottoms else "auto")
        for top in _aslist(layer_cfg.get("top")) or [name]:
            blob_to_layer[top] = name
    return net
