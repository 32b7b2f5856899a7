"""ONNX model importer -> dnn.Net (port of opencv_tpu/dnn/onnx_importer.py;
the reference's modules/dnn/src/onnx/onnx_importer.cpp).

Field numbers come from the public ONNX protobuf specification:
ModelProto.graph=7; GraphProto.node=1/.initializer=5/.input=11/
.output=12; NodeProto.input=1/.output=2/.op_type=4/.attribute=5;
AttributeProto.name=1/.f=2/.i=3/.s=4/.t=5/.floats=7/.ints=8;
TensorProto.dims=1/.data_type=2/.float_data=4/.int64_data=7/.name=8/
.raw_data=9.

The decoded graph lowers onto dnn/layers.py. The op semantics are the
JAX importer's, written from its functions rather than from torch's
nearest built-in: both SAME_UPPER and SAME_LOWER become XLA's "SAME"
(extra pad on the high side), average pooling divides by the count of
real (unpadded) cells, ConvTranspose is an input-dilated convolution
with the flipped, regrouped kernel, Resize follows each ONNX
coordinate_transformation_mode and nearest_mode, LRN sums the padded
channel window in order, and the LSTM gate order is permuted to the
layer's (i, f, o, g).
"""

from __future__ import annotations

import struct

import numpy as np
import torch
import torch.nn.functional as F

from opencv_tpu_torch.device import no_tf32
from opencv_tpu_torch.dnn import layers, proto
from opencv_tpu_torch.dnn.net import Net

_F = {  # TensorProto.DataType
    1: np.float32, 6: np.int32, 7: np.int64, 11: np.float64,
    10: np.float16, 9: np.bool_, 2: np.uint8, 3: np.int8,
}
_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
          np.dtype(np.int64): torch.int64, np.dtype(np.float64): torch.float64,
          np.dtype(np.float16): torch.float16, np.dtype(np.bool_): torch.bool,
          np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8}


def _tensor(fields) -> np.ndarray:
    dims = proto.get_ints(fields, 1)
    dtype = _F[proto.get_int(fields, 2, 1)]
    raw = proto.get_bytes(fields, 9)
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif dtype == np.float32:
        arr = np.asarray(proto.get_floats_packed(fields, 4), np.float32)
    elif dtype in (np.int64,):
        arr = np.asarray(proto.get_ints(fields, 7), np.int64)
    else:
        arr = np.asarray(proto.get_ints(fields, 5), np.int32).astype(dtype)
    return arr.reshape(dims) if dims else arr


def _attrs(node_fields) -> dict:
    out = {}
    for a in proto.get_messages(node_fields, 5):
        name = proto.get_str(a, 1)
        if 2 in a:
            out[name] = struct.unpack("<f", a[2][-1])[0]
        elif 3 in a:
            out[name] = proto.get_int(a, 3)
        elif 4 in a:
            out[name] = a[4][-1]
        elif 5 in a:
            out[name] = _tensor(proto.parse(a[5][-1]))
        elif 7 in a:
            out[name] = proto.get_floats_packed(a, 7)
        elif 8 in a:
            out[name] = proto.get_ints(a, 8)
        else:
            out[name] = None
    return out


def _conv_padding(attrs, spatial=2):
    pads = attrs.get("pads")
    if pads:
        return [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
    if attrs.get("auto_pad", b"NOTSET") in (b"SAME_UPPER", b"SAME_LOWER"):
        return "SAME"
    return [(0, 0)] * spatial


def _as_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)  # a copy: raw_data is read-only


def load_onnx(path_or_bytes, device=None) -> Net:
    """Parse an ONNX file (path or bytes) into a Net (readNetFromONNX
    analog). The weights go to the card unless `device="cpu"`."""
    if isinstance(path_or_bytes, str):
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    else:
        buf = bytes(path_or_bytes)
    model = proto.parse(buf)
    graph = proto.parse(proto.get_bytes(model, 7))
    consts: dict[str, np.ndarray] = {}
    for t in proto.get_messages(graph, 5):  # initializer
        consts[proto.get_str(t, 8)] = _tensor(t)
    # graph inputs that are not initializers = runtime inputs
    input_names = [proto.get_str(vi, 1) for vi in proto.get_messages(graph, 11)]
    input_names = [nm for nm in input_names if nm not in consts]
    net = Net(device)
    dev = net.device
    net._input_names = list(input_names) or ["data"]

    for nf in proto.get_messages(graph, 1):  # nodes
        op = proto.get_str(nf, 4)
        ins = proto.get_strs(nf, 1)
        outs = proto.get_strs(nf, 2)
        at = _attrs(nf)
        out_name = outs[0]

        def w(i):
            return _as_tensor(consts[ins[i]], dev)

        def c_list(i):
            return [int(v) for v in np.atleast_1d(consts[ins[i]])]

        if op == "Constant":
            consts[out_name] = at.get("value")
            continue
        if op == "Split":
            _add_split(net, ins, outs, at, consts)
            continue
        if op in ("LSTM", "GRU"):
            _add_rnn(net, op, ins, outs, at, consts)
            continue
        fn, srcs = _op(op, ins, at, consts, w, c_list, dev)
        net.add_layer(out_name, fn, srcs)
    # an initializer wired as a live layer input becomes a fixed input blob
    produced = {nm for nm, _, _ in net._layers}
    for _, _, in_names in list(net._layers):
        for nm in in_names:
            if nm not in produced and nm in consts and nm not in net._inputs:
                net.set_input(consts[nm], nm)
    return net


def _binary(fn, ins, consts, dev):
    """fn over the first two inputs, a constant bound into the closure as
    the SECOND operand whichever input it was (the JAX importer's rule)."""
    live = [nm for nm in ins[:2] if nm not in consts]
    if len(live) == 2:
        return fn, live
    cv = _as_tensor(consts[ins[0] if ins[0] in consts else ins[1]], dev)
    return (lambda x: fn(x, cv)), live


def _op(op, ins, at, consts, w, c_list, dev):
    """(fn, input names) of one node."""
    x0 = [ins[0]]
    if op == "Conv":
        stride = tuple(int(s) for s in at.get("strides", [1, 1]))
        weight, bias = w(1), (w(2) if len(ins) > 2 else None)
        pad, groups = _conv_padding(at), int(at.get("group", 1))
        return (lambda x: layers.convolution(x, weight, bias, stride, pad, groups)), x0
    if op == "Gemm":
        weight, bias = w(1), (w(2) if len(ins) > 2 else None)
        alpha, beta = float(at.get("alpha", 1.0)), float(at.get("beta", 1.0))
        wmat = weight if int(at.get("transB", 0)) else weight.T
        if alpha != 1.0:
            wmat = wmat * alpha
        if bias is not None and beta != 1.0:
            bias = bias * beta
        return (lambda x: layers.fully_connected(x, wmat, bias)), x0
    if op == "MatMul":
        if ins[1] in consts:
            weight = w(1)
            return (lambda x: _matmul(x, weight)), x0
        return _matmul, ins[:2]
    if op == "Relu":
        return layers.relu, x0
    if op == "LeakyRelu":
        alpha = float(at.get("alpha", 0.01))
        return (lambda x: torch.where(x > 0, x, alpha * x)), x0
    if op == "Sigmoid":
        return layers.sigmoid, x0
    if op == "Tanh":
        return torch.tanh, x0
    if op == "Clip":
        lo, hi = float(at.get("min", -3.4e38)), float(at.get("max", 3.4e38))
        return (lambda x: torch.clamp(x, lo, hi)), x0
    if op == "Softmax":
        axis = int(at.get("axis", -1))
        return (lambda x: layers.softmax(x, axis=axis)), x0
    if op in ("MaxPool", "AveragePool"):
        k = tuple(int(v) for v in at["kernel_shape"])
        stride = tuple(int(v) for v in at.get("strides", k))
        pad = _conv_padding(at)
        if pad == "SAME":
            pad = [(kk // 2, kk // 2) for kk in k]
        mode = "max" if op == "MaxPool" else "avg"
        return (lambda x: _pool(x, k, stride, pad, mode)), x0
    if op == "GlobalAveragePool":
        return (lambda x: x.mean(dim=(2, 3), keepdim=True)), x0
    if op == "GlobalMaxPool":
        return (lambda x: x.amax(dim=(2, 3), keepdim=True)), x0
    if op == "BatchNormalization":
        gamma, beta, mean, var = w(1), w(2), w(3), w(4)
        eps = float(at.get("epsilon", 1e-5))
        return (lambda x: layers.batch_norm(x, mean, var, gamma, beta, eps)), x0
    if op in ("Add", "Sub", "Mul", "Div"):
        return _binary({"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
                        "Div": torch.true_divide}[op], ins, consts, dev)
    if op == "Concat":
        axis = int(at.get("axis", 1))
        return (lambda *xs: torch.cat(xs, dim=axis)), ins
    if op == "Flatten":
        return layers.flatten, x0
    if op == "Reshape":
        shape = tuple(int(s) for s in consts[ins[1]].astype(np.int64))
        return (lambda x: x.reshape(tuple(x.shape[i] if s == 0 else s
                                          for i, s in enumerate(shape)))), x0
    if op == "Transpose":
        perm = tuple(int(p) for p in at["perm"])
        return (lambda x: x.permute(perm)), x0
    if op in ("Identity", "Dropout"):
        return (lambda x: x), x0
    if op in _UNARY:
        return _UNARY[op], x0
    if op == "Softplus":
        return (lambda x: torch.logaddexp(torch.zeros_like(x), x)), x0
    if op == "Elu":
        alpha = float(at.get("alpha", 1.0))
        return (lambda x: torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))), x0
    if op == "PRelu":
        slope = w(1)  # torch exports [C] or [C, 1, 1]; broadcast against NCHW

        def prelu(x):
            s = slope.reshape((1, -1) + (1,) * max(0, x.ndim - 2)) if slope.numel() > 1 \
                else slope.reshape(())
            return torch.where(x > 0, x, x * s)
        return prelu, x0
    if op == "HardSigmoid":
        alpha, beta = float(at.get("alpha", 0.2)), float(at.get("beta", 0.5))
        return (lambda x: torch.clamp(alpha * x + beta, 0.0, 1.0)), x0
    if op == "HardSwish":
        return (lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)), x0
    if op == "Cast":
        to = _TORCH[np.dtype(_F[int(at.get("to", 1))])]
        return (lambda x: x.to(to)), x0
    if op == "Pow":
        if len(ins) > 1 and ins[1] in consts:
            e = w(1)
            return (lambda x: torch.pow(x, e)), x0
        return torch.pow, ins[:2]
    if op in ("Min", "Max"):
        fn = torch.minimum if op == "Min" else torch.maximum
        live = [nm for nm in ins if nm not in consts]
        cvals = [_as_tensor(consts[nm], dev) for nm in ins if nm in consts]

        def variadic(*xs):
            out, rest = (list(xs) + cvals)[0], (list(xs) + cvals)[1:]
            for v in rest:
                out = fn(out, v)
            return out
        return variadic, live
    if op == "Where":
        # any of (cond, x, y) may be a constant initializer: bind it, wire the live ones
        binds = [_as_tensor(consts[nm], dev) if nm in consts else None for nm in ins[:3]]

        def where(*xs):
            it = iter(xs)
            c, a, b = [v if v is not None else next(it) for v in binds]
            return torch.where(c.to(torch.bool), a, b)
        return where, [nm for nm in ins[:3] if nm not in consts]
    if op == "Slice":
        if len(ins) > 1:  # opset >= 10: starts/ends/axes/steps inputs
            starts, ends = c_list(1), c_list(2)
            axes = c_list(3) if len(ins) > 3 and ins[3] else list(range(len(starts)))
            steps = c_list(4) if len(ins) > 4 and ins[4] else [1] * len(starts)
        else:  # opset 1: attributes
            starts, ends = [int(v) for v in at["starts"]], [int(v) for v in at["ends"]]
            axes = [int(v) for v in at.get("axes", range(len(starts)))]
            steps = [1] * len(starts)
        return (lambda x: _slice(x, starts, ends, axes, steps)), x0
    if op in ("Squeeze", "Unsqueeze"):
        if "axes" in at:
            axes = [int(v) for v in at["axes"]]
        elif len(ins) > 1 and ins[1] in consts:
            axes = c_list(1)
        else:
            axes = None
        if op == "Squeeze":
            return (lambda x: _squeeze(x, axes)), x0
        return (lambda x: _unsqueeze(x, axes)), x0
    if op == "Expand":
        shape = tuple(c_list(1))
        return (lambda x: x.broadcast_to(np.broadcast_shapes(tuple(x.shape), shape))), x0
    if op == "Gather":
        axis = int(at.get("axis", 0))
        if ins[1] in consts:
            idx = w(1)
            return (lambda x: _take(x, idx, axis)), x0
        return (lambda x, i: _take(x, i, axis)), ins[:2]
    if op == "Pad":
        mode = at.get("mode", b"constant").decode()
        if len(ins) > 1:  # opset >= 11
            pads = c_list(1)
            cval = (float(np.atleast_1d(consts[ins[2]])[0])
                    if len(ins) > 2 and ins[2] in consts else 0.0)
        else:
            pads, cval = [int(v) for v in at["pads"]], float(at.get("value", 0.0))
        if mode not in ("constant", "reflect", "edge"):
            raise KeyError(mode)
        return (lambda x: _pad(x, pads, cval, mode)), x0
    if op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin"):
        if "axes" in at and at["axes"]:
            axes = tuple(int(v) for v in at["axes"])
        elif len(ins) > 1 and ins[1] in consts:
            axes = tuple(c_list(1))
        else:
            axes = None
        keep = bool(at.get("keepdims", 1))
        fn = {"ReduceMean": torch.mean, "ReduceSum": torch.sum,
              "ReduceMax": torch.amax, "ReduceMin": torch.amin}[op]
        return (lambda x: fn(x, dim=axes if axes is not None else tuple(range(x.ndim)),
                             keepdim=keep)), x0
    if op == "InstanceNormalization":
        scale, bias = w(1), w(2)
        eps = float(at.get("epsilon", 1e-5))
        return (lambda x: (x - x.mean(dim=(2, 3), keepdim=True))
                / torch.sqrt(x.var(dim=(2, 3), keepdim=True, unbiased=False) + eps)
                * scale[None, :, None, None] + bias[None, :, None, None]), x0
    if op == "LRN":
        alpha, beta = float(at.get("alpha", 1e-4)), float(at.get("beta", 0.75))
        bias, size = float(at.get("bias", 1.0)), int(at["size"])
        return (lambda x: _lrn(x, size, alpha, beta, bias)), x0
    if op == "ConvTranspose":
        stride = tuple(int(s) for s in at.get("strides", [1, 1]))
        pads = at.get("pads", [0, 0, 0, 0])
        out_pad = at.get("output_padding", [0, 0])
        weight, bias = w(1), (w(2) if len(ins) > 2 else None)
        groups = int(at.get("group", 1))
        return (lambda x: _conv_transpose(x, weight, bias, stride, pads, out_pad, groups)), x0
    if op in ("Resize", "Upsample"):
        legacy = op == "Upsample" or len(ins) == 2
        # Upsample and opset-10 Resize(X, scales) predate the
        # coordinate_transformation_mode attribute: asymmetric, floor
        mode = at.get("mode", b"nearest").decode()
        coord = at.get("coordinate_transformation_mode",
                       b"asymmetric" if legacy else b"half_pixel").decode()
        nearest_mode = at.get("nearest_mode", b"floor" if legacy else b"round_prefer_floor").decode()
        if legacy:
            scales, sizes = [float(v) for v in np.atleast_1d(consts[ins[1]])], None
        elif len(ins) > 2 and ins[2] in consts and np.asarray(consts[ins[2]]).size:
            scales, sizes = [float(v) for v in np.atleast_1d(consts[ins[2]])], None
        else:
            scales, sizes = None, c_list(3)
        return (lambda x: _resize(x, scales, sizes, mode, coord, nearest_mode)), x0
    raise NotImplementedError(f"ONNX op {op!r} not supported")


def _add_split(net, ins, outs, at, consts):
    axis = int(at.get("axis", 0))
    if "split" in at:
        sizes = [int(v) for v in at["split"]]
    elif len(ins) > 1 and ins[1] in consts:
        sizes = [int(v) for v in np.atleast_1d(consts[ins[1]])]
    else:
        sizes = None  # equal split over len(outs)
    for oi, onm in enumerate(outs):  # one layer per output
        net.add_layer(onm, (lambda x, oi=oi: _split_chunk(x, oi, axis, sizes, len(outs))), [ins[0]])


def _add_rnn(net, op, ins, outs, at, consts):
    dev = net.device
    direction = at.get("direction", b"forward").decode()
    ndir = 2 if direction == "bidirectional" else 1
    W = np.asarray(consts[ins[1]])  # [ndir, G*H, D]
    Rm = np.asarray(consts[ins[2]])  # [ndir, G*H, H]
    B = np.asarray(consts[ins[3]]) if len(ins) > 3 and ins[3] in consts else None
    hidden = int(at.get("hidden_size", Rm.shape[2]))
    is_lstm = op == "LSTM"
    lbr = bool(at.get("linear_before_reset", 0))
    # optional inputs: sequence_lens (4), initial_h (5), initial_c (6)
    if len(ins) > 4 and ins[4]:
        raise NotImplementedError(f"ONNX {op}: per-sequence sequence_lens input is not "
                                  "supported (all sequences run full length)")
    H0 = Cc0 = None
    if len(ins) > 5 and ins[5]:
        if ins[5] not in consts:
            raise NotImplementedError(f"ONNX {op}: runtime (non-initializer) initial_h "
                                      "is not supported")
        H0 = np.asarray(consts[ins[5]])  # [ndir, N, H]
    if is_lstm and len(ins) > 6 and ins[6]:
        if ins[6] not in consts:
            raise NotImplementedError(f"ONNX {op}: runtime (non-initializer) initial_c "
                                      "is not supported")
        Cc0 = np.asarray(consts[ins[6]])

    def t(a):
        return None if a is None else _as_tensor(np.asarray(a, np.float32), dev)

    perm = _gate_perm(hidden, [0, 2, 1, 3])  # ONNX LSTM (i, o, f, c) -> (i, f, o, g)
    dirs = []
    for d in range(ndir):
        if is_lstm:
            b = None if B is None else B[d][:4 * hidden][perm] + B[d][4 * hidden:][perm]
            dirs.append((t(W[d][perm]), t(Rm[d][perm]), t(b), None))
        else:
            dirs.append((t(W[d]), t(Rm[d]), None if B is None else t(B[d][:3 * hidden]),
                         None if B is None else t(B[d][3 * hidden:])))

    def rnn_run(x):
        # x [T, N, D] (ONNX layout)
        ys_dirs, h_dirs, c_dirs = [], [], []
        for d, (wi, wh, b1, b2) in enumerate(dirs):
            rev = direction == "reverse" or d == 1
            xs = x.flip(0) if rev else x
            h0 = t(H0[d]) if H0 is not None else None
            if is_lstm:
                ys, (h_t, c_t) = layers.lstm(xs, wi, wh, b1, h0=h0,
                                             c0=t(Cc0[d]) if Cc0 is not None else None)
                c_dirs.append(c_t)
            else:
                ys, h_t = layers.gru(xs, wi, wh, b1, b2, h0=h0, linear_before_reset=lbr)
            ys_dirs.append(ys.flip(0) if rev else ys)
            h_dirs.append(h_t)
        return (torch.stack(ys_dirs, dim=1), torch.stack(h_dirs),
                torch.stack(c_dirs) if is_lstm else None)

    full = outs[0] + "__rnn_state"
    net.add_layer(full, rnn_run, [ins[0]])
    for k, onm in enumerate(outs[:3]):
        if onm:
            net.add_layer(onm, (lambda s, k=k: s[k]), [full])


def _gate_perm(h, order):
    """Row permutation turning gate-blocked [G*H, ...] weights from one
    gate order into another."""
    return np.concatenate([np.arange(h) + g * h for g in order])


_UNARY = {
    "Exp": torch.exp, "Log": torch.log, "Neg": torch.neg, "Abs": torch.abs,
    "Sqrt": torch.sqrt, "Floor": torch.floor, "Ceil": torch.ceil,
    "Reciprocal": lambda x: 1.0 / x, "Erf": torch.erf, "Sin": torch.sin, "Cos": torch.cos,
}


def _squeeze(x, axes):
    if not axes:
        return x.squeeze()
    return x.squeeze(tuple(a % x.ndim for a in axes))


def _unsqueeze(x, axes):
    nd = x.ndim + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def _take(x, idx, axis):
    """jnp.take along `axis` (negative indices count from the end)."""
    axis %= x.ndim
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))


def _slice(x, starts, ends, axes, steps):
    """numpy slicing semantics (negative steps included) per axis."""
    big = 1 << 40
    for s, e, a, st in zip(starts, ends, axes, steps):
        e = None if e >= big or e == 9223372036854775807 else e
        sel = np.arange(x.shape[a])[slice(s, e, st)]
        if st == 1 and sel.size:
            x = x.narrow(a, int(sel[0]), int(sel.size))
        else:
            x = x.index_select(a, torch.as_tensor(np.ascontiguousarray(sel), device=x.device))
    return x


def _split_chunk(x, oi, axis, sizes, nout):
    if sizes is None:
        # opset-18 equal-split rule: ceil(dim/nout) chunks, last smaller
        chunk = -(-x.shape[axis] // nout)
        sizes = [min(chunk, x.shape[axis] - i * chunk) for i in range(nout)]
    return x.narrow(axis, int(np.sum(sizes[:oi])), sizes[oi])


def _edge_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source index of each padded position (numpy's reflect or edge)."""
    i = np.arange(-lo, n + hi)
    if mode == "edge":
        return np.clip(i, 0, n - 1)
    period = 2 * (n - 1)
    i = np.abs(i) % period if period else np.zeros_like(i)
    return np.where(i >= n, period - i, i)


def _pad(x, pads, cval, mode):
    """ONNX Pad incl. negative entries (crop semantics): pad the
    non-negative part, then slice away the negative part."""
    nd = x.ndim
    pos = [(max(pads[i], 0), max(pads[i + nd], 0)) for i in range(nd)]
    if mode == "constant":
        flat = [v for lo_hi in reversed(pos) for v in lo_hi]
        out = F.pad(x, flat, value=cval) if any(flat) else x
    else:
        out = x
        for d, (lo, hi) in enumerate(pos):
            if lo or hi:
                idx = torch.as_tensor(_edge_index(out.shape[d], lo, hi, mode), device=x.device)
                out = out.index_select(d, idx)
    for d in range(nd):
        lo, hi = max(-pads[d], 0), max(-pads[d + nd], 0)
        if lo or hi:
            out = out.narrow(d, lo, out.shape[d] - lo - hi)
    return out


def _lrn(x, size, alpha, beta, bias):
    """Across-channel local response normalization (NCHW): the padded
    channel window summed in order."""
    half = size // 2
    pad = F.pad(x * x, (0, 0, 0, 0, half, size - 1 - half))
    den = torch.zeros_like(x)
    for i in range(size):
        den = den + pad[:, i:i + x.shape[1]]
    return x / (bias + (alpha / size) * den) ** beta


@no_tf32()
def _matmul(a, b):
    return a @ b


@no_tf32()
def _conv_transpose(x, weight, bias, stride, pads, out_pad, groups):
    """ONNX/torch ConvTranspose2d as a forward convolution of the
    input dilated by the stride: weight [Cin, Cout/g, kH, kW] ->
    grouped OIHW with a spatial flip; padding (k - 1 - pad) per edge plus
    output_padding on the trailing edge (negative: a crop)."""
    cin, cog, kh, kw = weight.shape
    wg = weight.reshape(groups, cin // groups, cog, kh, kw).transpose(1, 2)
    wg = wg.reshape(groups * cog, cin // groups, kh, kw).flip(2, 3)
    n, c, h, w = x.shape
    sh, sw = stride
    if sh > 1 or sw > 1:
        xd = x.new_zeros((n, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
        xd[:, :, ::sh, ::sw] = x
        x = xd
    pad_h = (kh - 1 - int(pads[0]), kh - 1 - int(pads[2]) + int(out_pad[0]))
    pad_w = (kw - 1 - int(pads[1]), kw - 1 - int(pads[3]) + int(out_pad[1]))
    out = F.conv2d(layers.pad_hw(x, [pad_h, pad_w]), wg, None, groups=groups)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def _resize_src_coords(out_n, in_n, coord):
    """Source (input-space) coordinate of each output index under an
    ONNX coordinate_transformation_mode (host f64, as the JAX function)."""
    i = np.arange(out_n, dtype=np.float64)
    s = in_n / out_n
    if coord == "half_pixel":
        return (i + 0.5) * s - 0.5
    if coord == "pytorch_half_pixel":
        return (i + 0.5) * s - 0.5 if out_n > 1 else np.zeros_like(i)
    if coord == "asymmetric":
        return i * s
    if coord == "align_corners":
        return i * ((in_n - 1) / (out_n - 1)) if out_n > 1 else i * 0.0
    raise NotImplementedError(f"ONNX Resize coordinate_transformation_mode {coord!r}")


_ROUND = {
    "round_prefer_floor": lambda v: np.ceil(v - 0.5),
    "round_prefer_ceil": lambda v: np.floor(v + 0.5),
    "floor": np.floor,
    "ceil": np.ceil,
}


@no_tf32()
def _resize(x, scales, sizes, mode, coord, nearest_mode="round_prefer_floor"):
    """ONNX Resize on NCHW with the per-mode conventions (separable)."""
    h, w = x.shape[2], x.shape[3]
    if sizes is not None:
        oh, ow = int(sizes[2]), int(sizes[3])
    else:  # ONNX: floor(len * scale), not round
        oh, ow = int(np.floor(h * scales[2])), int(np.floor(w * scales[3]))
    sy, sx = _resize_src_coords(oh, h, coord), _resize_src_coords(ow, w, coord)
    if mode == "nearest":
        if nearest_mode not in _ROUND:
            raise NotImplementedError(f"ONNX Resize nearest_mode {nearest_mode!r}")
        rnd = _ROUND[nearest_mode]
        iy = torch.as_tensor(np.clip(rnd(sy), 0, h - 1).astype(np.int64), device=x.device)
        ix = torch.as_tensor(np.clip(rnd(sx), 0, w - 1).astype(np.int64), device=x.device)
        return x[:, :, iy[:, None], ix[None, :]]
    if mode != "linear":
        raise NotImplementedError(f"ONNX Resize mode {mode!r}")

    def wmat(src, n):  # [out, n] bilinear weights, the border clamped first
        src = np.clip(src, 0.0, n - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n - 1)
        frac = src - lo
        m = np.zeros((len(src), n), np.float32)
        m[np.arange(len(src)), lo] += (1.0 - frac).astype(np.float32)
        m[np.arange(len(src)), hi] += frac.astype(np.float32)
        return torch.as_tensor(m, device=x.device)

    out = torch.einsum("oh,nchw,pw->ncop", wmat(sy, h), x.to(torch.float32), wmat(sx, w))
    return out.to(x.dtype)


def _pool(x, k, stride, pad, mode):
    """Max or average pooling with explicit pads; the average divides by
    the number of real (unpadded) cells of each window."""
    pads = [tuple(p) for p in pad]
    if mode == "max":
        return F.max_pool2d(layers.pad_hw(x, pads, -float("inf")), k, stride)
    s = F.avg_pool2d(layers.pad_hw(x, pads), k, stride, divisor_override=1)
    cnt = F.avg_pool2d(layers.pad_hw(torch.ones_like(x[:1, :1]), pads), k, stride,
                       divisor_override=1)
    return s / cnt
