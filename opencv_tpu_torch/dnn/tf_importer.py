"""TensorFlow GraphDef importer -> dnn.Net (port of
opencv_tpu/dnn/tf_importer.py; the reference's modules/dnn/src/tensorflow/).

Field numbers from the public TensorFlow protos: GraphDef.node=1;
NodeDef.name=1/.op=2/.input=3/.attr=5 (map entries: key=1, value=2);
AttrValue.s=2/.i=3/.f=4/.b=5/.type=6/.tensor=8/.list=1;
TensorProto.dtype=1/.tensor_shape=2/.tensor_content=4/.float_val=5/
.int_val=7; TensorShapeProto.dim=2 (Dim.size=1).

TF graphs are NHWC with HWIO kernels and the layout stays NHWC end to
end, as in the JAX importer: a convolution permutes to NCHW around
`F.conv2d` (HWIO -> OIHW), with XLA's "SAME"/"VALID" padding at any
stride; pooling likewise, the average over real (unpadded) cells.
"""

from __future__ import annotations

import struct

import numpy as np
import torch
import torch.nn.functional as F

from opencv_tpu_torch.device import no_tf32
from opencv_tpu_torch.dnn import layers, proto
from opencv_tpu_torch.dnn.net import Net

_DT = {1: np.float32, 3: np.int32, 9: np.int64, 10: np.bool_}


def _tf_tensor(fields) -> np.ndarray:
    dtype = _DT[proto.get_int(fields, 1, 1)]
    shape = []
    if 2 in fields:
        for d in proto.get_messages(proto.parse(fields[2][-1]), 2):
            shape.append(proto.get_int(d, 1, 0))
    raw = proto.get_bytes(fields, 4)
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif dtype == np.float32:
        arr = np.asarray(proto.get_floats_packed(fields, 5), np.float32)
    else:
        arr = np.asarray(proto.get_ints(fields, 7), dtype)
    if shape:
        if arr.size == 1 and int(np.prod(shape)) > 1:
            arr = np.broadcast_to(arr, shape).copy()
        arr = arr.reshape(shape)
    return arr


def _attrs(node_fields) -> dict:
    out = {}
    for entry in proto.get_messages(node_fields, 5):
        key = proto.get_str(entry, 1)
        av = proto.parse(proto.get_bytes(entry, 2))
        if 2 in av:
            out[key] = av[2][-1]  # bytes (s)
        elif 3 in av:
            out[key] = av[3][-1]  # int
        elif 4 in av:
            out[key] = struct.unpack("<f", av[4][-1])[0]
        elif 5 in av:
            out[key] = bool(av[5][-1])
        elif 8 in av:
            out[key] = _tf_tensor(proto.parse(av[8][-1]))
        elif 1 in av:  # list
            lst = proto.parse(av[1][-1])
            if 3 in lst:
                out[key] = proto.get_ints(lst, 3)
            elif 4 in lst:
                out[key] = proto.get_floats_packed(lst, 4)
            else:
                out[key] = proto.get_strs(lst, 2)
        elif 6 in av:
            out[key] = av[6][-1]  # dtype enum
    return out


def _pad_of(attrs) -> str:
    return (attrs.get("padding", b"VALID") or b"VALID").decode()


def _conv_nhwc(x, kern_oihw, stride, pad, groups=1):
    """NHWC convolution through NCHW F.conv2d with XLA's padding string."""
    y = layers.convolution(x.permute(0, 3, 1, 2), kern_oihw, None, stride, pad, groups)
    return y.permute(0, 2, 3, 1)


def _pool_nhwc(x, k, s, pad, mode):
    xc = x.permute(0, 3, 1, 2)
    pads = layers.conv_pads(pad, xc.shape[2:], k, s)
    if mode == "MaxPool":
        y = F.max_pool2d(layers.pad_hw(xc, pads, -float("inf")), k, s)
    else:
        tot = F.avg_pool2d(layers.pad_hw(xc, pads), k, s, divisor_override=1)
        cnt = F.avg_pool2d(layers.pad_hw(torch.ones_like(xc[:1, :1]), pads), k, s,
                           divisor_override=1)
        y = tot / cnt
    return y.permute(0, 2, 3, 1)


def load_tf(path_or_bytes, device=None) -> Net:
    """Parse a frozen GraphDef into a Net (readNetFromTensorflow analog).
    Layout stays NHWC; Placeholder nodes become Net inputs. The weights
    go to the card unless `device="cpu"`."""
    if isinstance(path_or_bytes, str):
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    else:
        buf = bytes(path_or_bytes)
    g = proto.parse(buf)
    net = Net(device)
    consts: dict[str, np.ndarray] = {}
    input_names: list[str] = []

    def src(name):
        # TF input refs may carry ":0" ports or "^" control edges
        return name.lstrip("^").split(":")[0]

    for nf in proto.get_messages(g, 1):
        name, op = proto.get_str(nf, 1), proto.get_str(nf, 2)
        ins = [src(s) for s in proto.get_strs(nf, 3) if not s.startswith("^")]
        at = _attrs(nf)
        if op == "Const":
            consts[name] = at["value"]
            continue
        if op == "Placeholder":
            input_names.append(name)
            continue

        def cval(i):
            return torch.as_tensor(np.array(consts[ins[i]]), device=net.device)

        x0 = [ins[0]] if ins else []
        strides = tuple(int(s) for s in at.get("strides", [1, 1, 1, 1]))[1:3]
        if op == "Conv2D":
            kern = cval(1).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW

            def fn(x, kern=kern, s=strides, pad=_pad_of(at)):
                return _conv_nhwc(x, kern, s, pad)
        elif op == "DepthwiseConv2dNative":
            kern = cval(1)  # [H, W, C, M] -> [C*M, 1, H, W], groups C
            kh, kw, c, m = kern.shape

            def fn(x, kern=kern.reshape(kh, kw, 1, c * m).permute(3, 2, 0, 1).contiguous(),
                   s=strides, pad=_pad_of(at), groups=c):
                return _conv_nhwc(x, kern, s, pad, groups)
        elif op == "BiasAdd":
            def fn(x, b=cval(1)):
                return x + b
        elif op == "Relu":
            fn = layers.relu
        elif op == "Relu6":
            def fn(x):
                return torch.clamp(x, 0.0, 6.0)
        elif op == "Sigmoid":
            fn = torch.sigmoid
        elif op in ("MaxPool", "AvgPool"):
            def fn(x, k=tuple(int(v) for v in at["ksize"])[1:3],
                   s=tuple(int(v) for v in at["strides"])[1:3], pad=_pad_of(at), mode=op):
                return _pool_nhwc(x, k, s, pad, mode)
        elif op == "MatMul":
            wmat = cval(1)
            if at.get("transpose_b", False):
                wmat = wmat.T

            @no_tf32()
            def fn(x, wmat=wmat):
                return x @ wmat
        elif op in ("Add", "AddV2", "Sub", "Mul", "RealDiv"):
            bop = {"Add": torch.add, "AddV2": torch.add, "Sub": torch.sub,
                   "Mul": torch.mul, "RealDiv": torch.true_divide}[op]
            if ins[1] in consts:
                def fn(x, bop=bop, cv=cval(1)):
                    return bop(x, cv)
            else:
                fn, x0 = bop, ins[:2]
        elif op in ("FusedBatchNorm", "FusedBatchNormV3"):
            def fn(x, gamma=cval(1), beta=cval(2), mean=cval(3), var=cval(4),
                   eps=float(at.get("epsilon", 1e-3))):
                return (x - mean) / torch.sqrt(var + eps) * gamma + beta
        elif op == "Reshape":
            shape = tuple(int(v) for v in consts[ins[1]].reshape(-1))

            def fn(x, shape=shape):
                return x.reshape(tuple(x.shape[0] if s == -1 and i == 0 else s
                                       for i, s in enumerate(shape)))
        elif op == "Softmax":
            def fn(x):
                return torch.softmax(x, dim=-1)
        elif op in ("Identity", "NoOp"):
            if not ins:
                continue

            def fn(x):
                return x
        elif op == "ConcatV2":
            axis = int(consts[ins[-1]].reshape(-1)[0])
            x0 = ins[:-1]

            def fn(*xs, axis=axis):
                return torch.cat(xs, dim=axis)
        elif op == "Mean":  # global average pool pattern
            axes = tuple(int(v) for v in consts[ins[1]].reshape(-1))
            keep = bool(at.get("keep_dims", at.get("keepdims", False)))

            def fn(x, axes=axes, keep=keep):
                return x.mean(dim=axes, keepdim=keep)
        else:
            raise NotImplementedError(f"TF op {op!r} not supported")
        net.add_layer(name, fn, x0)
    net._input_names = input_names or ["input"]
    return net
