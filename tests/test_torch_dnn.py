"""The dnn module of the PyTorch port against the JAX package on the CPU.

Every layer of `dnn/layers.py`, the committed tiny_cnn ONNX fixture, the
Darknet nets of tests/test_darknet.py and tests/test_dnn_detection.py,
one hand-built ONNX graph per op group (as tests/test_onnx_ops.py builds
them), and one Caffe and one TF net (as tests/test_dnn_importers.py and
tests/test_tf_importer.py build them) go through both packages with the
same numpy-seeded inputs and the same model bytes.

Tolerance: rtol 1e-5, atol 1e-5 on float outputs (the JAX tests hold
these layers to torch at atol 2e-4 and rtol 1e-4: convolution and
matmul sum in the library's order on each side, and XLA fuses
multiply-adds under jit); the tiny_cnn fixture within 1e-5 of its
committed expected output (tests/test_dnn_fixture.py's bound). Integer
outputs (NMS indices, keep flags) and the prior boxes are exact.
"""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_tpu.dnn import caffe_importer as j_caffe
from opencv_tpu.dnn import darknet_importer as j_dark
from opencv_tpu.dnn import layers as jl
from opencv_tpu.dnn import onnx_importer as j_onnx
from opencv_tpu.dnn import proto as j_proto
from opencv_tpu.dnn import tf_importer as j_tf
from opencv_tpu_torch.device import no_tf32
from opencv_tpu_torch.dnn import caffe_importer, darknet_importer, onnx_importer, proto, tf_importer
from opencv_tpu_torch.dnn import layers as tl

from test_darknet import _CFG as DARKNET_CFG, _weights_stream
from test_dnn_detection import TINY_CFG, _weights_blob
from test_dnn_importers import (_PROTOTXT, _attr_float, _attr_int, _attr_ints, _caffemodel, _node,
                                _onnx_model, _onnx_tensor, _onnx_tensor_i64)
from test_tf_importer import _attr, _av_ints, _av_s, _av_tensor
from test_tf_importer import _node as _tf_node

RTOL = ATOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(11)


# ------------------------------------------------------------------ layers

CONV_CASES = {
    "same_stride2_even_kernel": ((2, 3, 9, 11), (4, 3, 4, 4), 2, "SAME", 1),
    "same_stride1": ((1, 2, 8, 7), (3, 2, 3, 3), 1, "SAME", 1),
    "valid_stride2": ((1, 2, 9, 9), (3, 2, 3, 3), 2, "VALID", 1),
    "explicit_asymmetric": ((1, 2, 7, 8), (3, 2, 3, 2), (2, 1), [(1, 2), (0, 1)], 1),
    "grouped": ((1, 6, 8, 8), (6, 2, 3, 3), 1, [(1, 1), (1, 1)], 3),
}


@pytest.mark.parametrize("case", CONV_CASES)
def test_convolution(rng, case):
    """XLA's padding rules: "SAME" puts the odd pixel on the high side at
    any stride (F.conv2d refuses padding="same" at stride > 1)."""
    xs, ws, stride, pad, groups = CONV_CASES[case]
    x = rng.normal(0, 1, xs).astype(np.float32)
    w = rng.normal(0, 0.3, ws).astype(np.float32)
    b = rng.normal(0, 0.1, ws[0]).astype(np.float32)
    want = jl.convolution(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, pad, groups)
    with no_tf32():
        got = tl.convolution(_t(x), _t(w), _t(b), stride, pad, groups)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("ksize,stride", [(2, None), (3, 1), (3, 2), (2, 1)])
def test_pools(rng, ksize, stride):
    """VALID max and average pooling (a 2x2 stride-1 pool shrinks 13 to
    12, the JAX layer's behaviour, kept)."""
    x = rng.normal(0, 1, (2, 3, 13, 10)).astype(np.float32)
    for jf, tf in ((jl.max_pool, tl.max_pool), (jl.avg_pool, tl.avg_pool)):
        want = jf(jnp.asarray(x), ksize, stride)
        got = tf(_t(x), ksize, stride)
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_dense_layers(rng):
    """fully_connected, batch_norm (4-D and 2-D), relu, sigmoid, softmax,
    concat, flatten."""
    x = rng.normal(0, 1, (3, 4, 5, 5)).astype(np.float32)
    w = rng.normal(0, 0.2, (7, 100)).astype(np.float32)
    b = rng.normal(0, 0.1, 7).astype(np.float32)
    mean, gamma, beta = (rng.normal(0, 0.2, 4).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    with no_tf32():
        _close(tl.fully_connected(_t(x), _t(w), _t(b)),
               jl.fully_connected(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    _close(tl.batch_norm(_t(x), _t(mean), _t(var), _t(gamma), _t(beta)),
           jl.batch_norm(*map(jnp.asarray, (x, mean, var, gamma, beta))))
    x2 = x[:, :, 0, 0]
    _close(tl.batch_norm(_t(x2), _t(mean), _t(var), _t(gamma), _t(beta)),
           jl.batch_norm(*map(jnp.asarray, (x2, mean, var, gamma, beta))))
    for jf, tf in ((jl.relu, tl.relu), (jl.sigmoid, tl.sigmoid), (jl.softmax, tl.softmax),
                   (jl.flatten, tl.flatten)):
        _close(tf(_t(x)), jf(jnp.asarray(x)))
    _close(tl.concat([_t(x), _t(x)], 1), jl.concat([jnp.asarray(x)] * 2, 1))


@pytest.mark.parametrize("use_softmax,wh_norm", [(True, None), (False, (64.0, 48.0))])
def test_region_decode(rng, use_softmax, wh_norm):
    classes, a, h, w = 4, 3, 5, 7
    x = rng.normal(0, 1.5, (2, a * (5 + classes), h, w)).astype(np.float32)
    anchors = rng.uniform(0.5, 3.0, (a, 2)).astype(np.float32)
    want = jl.region_decode(jnp.asarray(x), jnp.asarray(anchors), classes, use_softmax, 0.2, wh_norm)
    _close(tl.region_decode(_t(x), _t(anchors), classes, use_softmax, 0.2, wh_norm), want)


def test_nms_boxes(rng):
    """Greedy NMS: the kept indices and flags equal, ties of scores
    included (argmax keeps the first)."""
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (60, 2)), rng.uniform(0.05, 0.3, (60, 2))], 1)
    boxes = boxes.astype(np.float32)
    scores = np.round(rng.uniform(0, 1, 60), 1).astype(np.float32)  # many ties
    for iou, sthr, k in ((0.4, 0.0, 64), (0.3, 0.5, 8)):
        ji, jk = jl.nms_boxes(jnp.asarray(boxes), jnp.asarray(scores), iou, sthr, k)
        ti, tk = tl.nms_boxes(_t(boxes), _t(scores), iou, sthr, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_prior_box_and_detection_output(rng):
    jp, jv = jl.prior_box(3, 4, 90, 120, 30.0, 60.0, (2.0, 3.0), clip=True)
    tp, tv = tl.prior_box(3, 4, 90, 120, 30.0, 60.0, (2.0, 3.0), clip=True, device="cpu")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    k, nc = tp.shape[0], 4
    loc = rng.normal(0, 0.5, (2, k * 4)).astype(np.float32)
    conf = rng.uniform(0, 1, (2, k * nc)).astype(np.float32)
    want = jl.detection_output(jnp.asarray(loc), jnp.asarray(conf), jp, jv, nc,
                               conf_threshold=0.3, nms_threshold=0.45, top_k=10)
    _close(tl.detection_output(_t(loc), _t(conf), tp, tv, nc, conf_threshold=0.3,
                               nms_threshold=0.45, top_k=10), want)


def test_lstm_gru(rng):
    t_len, n, d, h = 6, 2, 5, 4
    x = rng.normal(0, 1, (t_len, n, d)).astype(np.float32)
    w4 = rng.normal(0, 0.4, (4 * h, d)).astype(np.float32)
    r4 = rng.normal(0, 0.4, (4 * h, h)).astype(np.float32)
    b4 = rng.normal(0, 0.1, 4 * h).astype(np.float32)
    h0, c0 = rng.normal(0, 0.5, (2, n, h)).astype(np.float32)
    with no_tf32():
        ys, (hT, cT) = tl.lstm(_t(x), _t(w4), _t(r4), _t(b4), _t(h0), _t(c0))
    jys, (jh, jc) = jl.lstm(*map(jnp.asarray, (x, w4, r4, b4, h0, c0)))
    for a, b in ((ys, jys), (hT, jh), (cT, jc)):
        _close(a, b)
    w3 = rng.normal(0, 0.4, (3 * h, d)).astype(np.float32)
    r3 = rng.normal(0, 0.4, (3 * h, h)).astype(np.float32)
    bi, bh = rng.normal(0, 0.1, (2, 3 * h)).astype(np.float32)
    for lbr in (True, False):
        with no_tf32():
            ys, hT = tl.gru(_t(x), _t(w3), _t(r3), _t(bi), _t(bh), _t(h0), lbr)
        jys, jh = jl.gru(*map(jnp.asarray, (x, w3, r3, bi, bh, h0)), linear_before_reset=lbr)
        _close(ys, jys)
        _close(hT, jh)


# ------------------------------------------------------------- fixture, darknet


def test_tiny_cnn_fixture():
    """tests/fixtures/tiny_cnn.onnx from disk: within 1e-5 of the committed
    expected output (test_dnn_fixture.py's bound) and of the JAX importer."""
    path = os.path.join(FIXTURES, "tiny_cnn.onnx")
    x = np.load(os.path.join(FIXTURES, "tiny_cnn_input.npy"))
    net = onnx_importer.load_onnx(path, device="cpu")
    net.set_input(x, "input")
    with no_tf32():
        got = net.forward("out").numpy()
    assert np.abs(got - np.load(os.path.join(FIXTURES, "tiny_cnn_expected.npy"))).max() < 1e-5
    jnet = j_onnx.load_onnx(path)
    jnet.set_input(x, "input")
    _close(got, jnet.forward("out"))


def _darknet_pair(cfg, weights, x):
    jnet = j_dark.load_darknet(cfg, weights)
    jnet.set_input(x)
    net = darknet_importer.load_darknet(cfg, weights, device="cpu")
    net.set_input(x)
    with no_tf32():
        return net.forward(), jnet.forward(), net


def test_darknet_cfgs(rng):
    """The cfg of tests/test_darknet.py (BN, leaky, maxpool, shortcut,
    route, logistic) and the region net of tests/test_dnn_detection.py."""
    arrs = [rng.normal(0, 0.2, s).astype(np.float32) for s in
            (4, 4, 4, 4, (4, 1, 3, 3), 6, (6, 4, 3, 3), 2, (2, 10, 1, 1))]
    arrs[1], arrs[3] = np.abs(arrs[1]) + 0.5, np.abs(arrs[3]) + 0.5  # scales, variances
    got, want, _ = _darknet_pair(DARKNET_CFG, _weights_stream(arrs),
                                 rng.normal(0, 1, (1, 1, 16, 16)).astype(np.float32))
    _close(got, want)

    def conv(cout, cin, k, bn):
        p = [rng.normal(0, 0.3, (cout, cin, k, k)), rng.normal(0, 0.1, cout)]
        if bn:
            p += [rng.uniform(0.5, 1.5, cout), rng.normal(0, 0.1, cout), rng.uniform(0.5, 1.5, cout)]
        return tuple(np.asarray(a, np.float32) for a in p)

    params = (conv(8, 3, 3, True), conv(16, 8, 3, True), conv(27, 16, 1, False))
    got, want, net = _darknet_pair(TINY_CFG, _weights_blob(params),
                                   rng.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32))
    _close(got, want)
    assert net.layer_names()[-1] == "l5_region"


def test_darknet_stride1_maxpool_is_valid(rng):
    """[maxpool] size=2 stride=1 (yolov2-tiny's sixth pool) shrinks 13 to
    12 in both packages; darknet itself would pad."""
    cfg = "[net]\nchannels=2\n\n[maxpool]\nsize=2\nstride=1\n"
    got, want, _ = _darknet_pair(cfg, None, rng.normal(0, 1, (1, 2, 13, 13)).astype(np.float32))
    assert tuple(got.shape) == (1, 2, 12, 12)
    _close(got, want)


# ------------------------------------------------------------------ ONNX groups


def _attr_str(name, s):
    return j_proto.field_str(1, name) + j_proto.field_str(4, s)


def _run_onnx(nodes, inits, x, outs=("out",)):
    model = _onnx_model(nodes, inits, ["input"], list(outs))
    jnet = j_onnx.load_onnx(model)
    jnet.set_input(x, "input")
    net = onnx_importer.load_onnx(model, device="cpu")
    net.set_input(x, "input")
    with no_tf32():
        for o in outs:
            got, want = net.forward(o), jnet.forward(o)
            assert tuple(got.shape) == tuple(want.shape), o
            _close(got, want)


def _onnx_groups(rng):
    f32 = np.float32

    def r(*s, scale=0.3):
        return rng.normal(0, scale, s).astype(f32)

    return {
        "conv_transpose_asymmetric": (
            [_node("ConvTranspose", ["input", "w", "b"], ["ct"],
                   [_attr_ints("strides", [2, 2]), _attr_ints("pads", [0, 1, 1, 2]),
                    _attr_ints("output_padding", [1, 0])]),
             _node("ConvTranspose", ["ct", "wg"], ["out"], [_attr_int("group", 2)])],
            [_onnx_tensor("w", r(3, 4, 3, 3)), _onnx_tensor("b", r(4, scale=0.1)),
             _onnx_tensor("wg", r(4, 3, 2, 2))], r(2, 3, 5, 6, scale=1.0)),
        "conv_auto_pad": (
            [_node("Conv", ["input", "w"], ["c1"], [_attr_ints("strides", [2, 2]),
                                                   _attr_str("auto_pad", "SAME_UPPER")]),
             _node("Conv", ["c1", "w2"], ["out"], [_attr_str("auto_pad", "SAME_LOWER")])],
            [_onnx_tensor("w", r(4, 3, 4, 4)), _onnx_tensor("w2", r(2, 4, 2, 2))],
            r(1, 3, 9, 10, scale=1.0)),
        "pads": (
            [_node("Pad", ["input", "p1"], ["a"], [_attr_str("mode", "reflect")]),
             _node("Pad", ["a", "p2"], ["b"], [_attr_str("mode", "edge")]),
             _node("Pad", ["b", "p3", "cv"], ["out"])],
            [_onnx_tensor_i64("p1", [0, 0, 2, 1, 0, 0, 1, 3]),
             _onnx_tensor_i64("p2", [0, 0, 1, 0, 0, 0, 0, 2]),
             _onnx_tensor_i64("p3", [0, 1, -1, 2, 0, 0, 1, -2]), _onnx_tensor("cv", f32(0.5))],
            r(2, 2, 5, 6, scale=1.0)),
        "resize_modes": (
            [_node("Resize", ["input", "", "s1"], ["a"],
                   [_attr_str("mode", "nearest"), _attr_str("coordinate_transformation_mode", "half_pixel")]),
             _node("Resize", ["input", "", "s2"], ["b"],
                   [_attr_str("mode", "linear"), _attr_str("coordinate_transformation_mode", "align_corners")]),
             _node("Resize", ["input", "", "", "sz"], ["c"],
                   [_attr_str("mode", "linear"), _attr_str("coordinate_transformation_mode", "pytorch_half_pixel")]),
             _node("Resize", ["input", "s3"], ["d"]),
             _node("Resize", ["input", "", "", "sz"], ["e"],
                   [_attr_str("mode", "nearest"), _attr_str("nearest_mode", "round_prefer_ceil"),
                    _attr_str("coordinate_transformation_mode", "asymmetric")]),
             _node("Resize", ["input", "", "s2"], ["out"], [_attr_str("mode", "linear")])],
            [_onnx_tensor("s1", [1, 1, 2.5, 1.5]), _onnx_tensor("s2", [1, 1, 1.7, 2.0]),
             _onnx_tensor("s3", [1, 1, 2.0, 3.0]), _onnx_tensor_i64("sz", [2, 3, 7, 5])],
            r(2, 3, 4, 5, scale=1.0), ("a", "b", "c", "d", "e", "out")),
        "lrn": (
            [_node("LRN", ["input"], ["out"], [_attr_int("size", 4), _attr_float("alpha", 1e-2),
                                               _attr_float("beta", 0.6), _attr_float("bias", 2.0)])],
            [], r(2, 7, 4, 4, scale=2.0)),
        "pooling_with_pads": (
            [_node("MaxPool", ["input"], ["m"], [_attr_ints("kernel_shape", [3, 3]),
                                                 _attr_ints("strides", [2, 2]),
                                                 _attr_ints("pads", [1, 0, 1, 2])]),
             _node("AveragePool", ["input"], ["a"], [_attr_ints("kernel_shape", [3, 2]),
                                                     _attr_ints("strides", [1, 2]),
                                                     _attr_ints("pads", [2, 1, 0, 1])]),
             _node("AveragePool", ["input"], ["s"], [_attr_ints("kernel_shape", [3, 3]),
                                                     _attr_str("auto_pad", "SAME_UPPER")]),
             _node("GlobalMaxPool", ["input"], ["gm"]), _node("GlobalAveragePool", ["input"], ["out"])],
            [], r(2, 3, 7, 8, scale=1.0), ("m", "a", "s", "gm", "out")),
        "gemm_matmul": (
            [_node("Gemm", ["input", "w1", "b1"], ["g1"], [_attr_int("transB", 1),
                                                           _attr_float("alpha", 0.5),
                                                           _attr_float("beta", 2.0)]),
             _node("Gemm", ["g1", "w2", "b2"], ["g2"]),
             _node("MatMul", ["g2", "w3"], ["m1"]),
             _node("Transpose", ["m1"], ["m1t"], [_attr_ints("perm", [1, 0])]),
             _node("MatMul", ["m1", "m1t"], ["out"])],
            [_onnx_tensor("w1", r(6, 12)), _onnx_tensor("b1", r(6, scale=0.1)),
             _onnx_tensor("w2", r(6, 5)), _onnx_tensor("b2", r(5, scale=0.1)),
             _onnx_tensor("w3", r(5, 4))], r(3, 12, scale=1.0)),
        "tensor_ops": (
            [_node("Slice", ["input", "st", "en", "ax", "sp"], ["sl"]),
             _node("Unsqueeze", ["sl"], ["us"], [_attr_ints("axes", [0, -1])]),
             _node("Squeeze", ["us"], ["sq"], [_attr_ints("axes", [0])]),
             _node("Gather", ["sq", "gi"], ["ga"], [_attr_int("axis", 1)]),
             _node("ReduceMax", ["ga"], ["rm"], [_attr_ints("axes", [-1]), _attr_int("keepdims", 0)]),
             _node("ReduceSum", ["rm"], ["rs"], [_attr_ints("axes", [2])]),
             _node("Expand", ["rs", "shp"], ["ex"]),
             _node("Where", ["cond", "ex", "zero"], ["wh"]),
             _node("Max", ["wh", "input2"], ["mx"]),
             _node("Split", ["mx"], ["s0", "s1"], [_attr_int("axis", 1), _attr_ints("split", [1, 2])]),
             _node("Concat", ["s1", "s0"], ["cc"], [_attr_int("axis", 1)]),
             _node("Cast", ["cc"], ["ci"], [_attr_int("to", 6)]),
             _node("Cast", ["ci"], ["cf"], [_attr_int("to", 1)]),
             _node("Flatten", ["cf"], ["fl"]),
             _node("Reshape", ["fl", "rsh"], ["out"])],
            [_onnx_tensor_i64("st", [4, 0]), _onnx_tensor_i64("en", [-100, 5]),
             _onnx_tensor_i64("ax", [3, 2]), _onnx_tensor_i64("sp", [-2, 2]),
             _onnx_tensor_i64("gi", [1, 0, -1]), _onnx_tensor_i64("shp", [1, 1, 4, 1]),
             _onnx_tensor("cond", (rng.random((1, 4, 1)) > 0.5).astype(f32)),
             _onnx_tensor("zero", f32(0.0)), _onnx_tensor("input2", r(3, 1, 1, scale=3.0)),
             _onnx_tensor_i64("rsh", [0, -1])], r(2, 3, 6, 7, scale=3.0)),
        "activations": (
            [_node("Elu", ["input"], ["a"], [_attr_float("alpha", 0.7)]),
             _node("HardSigmoid", ["a"], ["b"]), _node("HardSwish", ["input"], ["c"]),
             _node("Softplus", ["c"], ["d"]), _node("LeakyRelu", ["d"], ["e"]),
             _node("PRelu", ["input", "slope"], ["f"]), _node("Clip", ["f"], ["g"],
                                                            [_attr_float("min", -0.5), _attr_float("max", 0.8)]),
             _node("Erf", ["g"], ["h"]), _node("Abs", ["h"], ["i"]), _node("Sqrt", ["i"], ["j"]),
             _node("Sub", ["j", "b"], ["k"]), _node("Div", ["k", "two"], ["l"]),
             _node("Pow", ["l", "two"], ["m"]), _node("Mul", ["m", "e"], ["n"]),
             _node("Tanh", ["n"], ["o"]), _node("Softmax", ["o"], ["out"], [_attr_int("axis", 1)])],
            [_onnx_tensor("slope", rng.uniform(0.05, 0.3, (3, 1, 1)).astype(f32)),
             _onnx_tensor("two", f32(2.0))], r(2, 3, 4, 5, scale=2.0)),
    }


ONNX_GROUPS = ("conv_transpose_asymmetric", "conv_auto_pad", "pads", "resize_modes", "lrn",
               "pooling_with_pads", "gemm_matmul", "tensor_ops", "activations")


@pytest.mark.parametrize("group", ONNX_GROUPS)
def test_onnx_op_group(rng, group):
    nodes, inits, x, *outs = _onnx_groups(rng)[group]
    _run_onnx(nodes, inits, x, *outs)


def _gate_rows(h, order):
    return np.concatenate([np.arange(h) + g * h for g in order])


@pytest.mark.parametrize("op", ["LSTM", "GRU"])
def test_onnx_rnn(rng, op):
    """ONNX LSTM (gate order i, o, f, c, permuted to the layer's) both
    directions with an initial state; GRU with linear_before_reset."""
    t_len, n, d, h = 5, 2, 4, 3
    g = 4 if op == "LSTM" else 3
    inits = [_onnx_tensor("W", rng.normal(0, 0.4, (2, g * h, d))),
             _onnx_tensor("R", rng.normal(0, 0.4, (2, g * h, h))),
             _onnx_tensor("B", rng.normal(0, 0.1, (2, 2 * g * h))),
             _onnx_tensor("h0", rng.normal(0, 0.5, (2, n, h)))]
    ins = ["input", "W", "R", "B", "", "h0"]
    outs = ["Y", "Yh"]
    attrs = [_attr_int("hidden_size", h), _attr_str("direction", "bidirectional")]
    if op == "LSTM":
        inits.append(_onnx_tensor("c0", rng.normal(0, 0.5, (2, n, h))))
        ins.append("c0")
        outs.append("Yc")
    else:
        attrs.append(_attr_int("linear_before_reset", 1))
    x = rng.normal(0, 1, (t_len, n, d)).astype(np.float32)
    _run_onnx([_node(op, ins, outs, attrs)], inits, x, tuple(outs))


# ------------------------------------------------------------- Caffe, TF

_PROTOTXT_BN = """
input: "data"
layer { name: "conv1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 2 group: 2 } }
layer { name: "bn1" type: "BatchNorm" bottom: "c1" top: "c1" }
layer { name: "sc1" type: "Scale" bottom: "c1" top: "c1" }
layer { name: "relu1" type: "ReLU" bottom: "c1" top: "c1" }
layer { name: "pool1" type: "Pooling" bottom: "c1" top: "p1"
  pooling_param { pool: AVE kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "sum" type: "Eltwise" bottom: "p1" bottom: "c1" top: "e1" }
layer { name: "cat" type: "Concat" bottom: "e1" bottom: "c1" top: "cat" }
layer { name: "gp" type: "Pooling" bottom: "cat" top: "out"
  pooling_param { pool: MAX global_pooling: true } }
"""


def test_caffe_nets(rng):
    """tests/test_dnn_importers.py's net, and one with grouped stride-2
    convolution, BatchNorm/Scale in place, padded average pooling,
    Eltwise, Concat and global pooling."""
    w = {"conv1": [rng.normal(0, 0.3, (3, 1, 3, 3)), rng.normal(0, 0.1, 3)],
         "fc1": [rng.normal(0, 0.1, (5, 3 * 6 * 6)), rng.normal(0, 0.1, 5)]}
    w2 = {"conv1": [rng.normal(0, 0.3, (4, 1, 3, 3)), rng.normal(0, 0.1, 4)],
          "bn1": [rng.normal(0, 0.1, 4) * 2, rng.uniform(0.5, 1.5, 4) * 2, np.array([2.0])],
          "sc1": [rng.uniform(0.5, 1.5, 4), rng.normal(0, 0.1, 4)]}
    for text, blobs, shape, out in ((_PROTOTXT, w, (1, 1, 12, 12), "prob"),
                                    (_PROTOTXT_BN, w2, (2, 2, 9, 8), "gp")):
        model = _caffemodel(blobs)
        x = rng.normal(0, 1, shape).astype(np.float32)
        jnet = j_caffe.load_caffe(text, model)
        jnet.set_input(x, "data")
        net = caffe_importer.load_caffe(text, model, device="cpu")
        net.set_input(x, "data")
        with no_tf32():
            _close(net.forward(out), jnet.forward(out))
    assert caffe_importer.parse_prototxt(_PROTOTXT) == j_caffe.parse_prototxt(_PROTOTXT)


def test_tf_net(rng):
    """NHWC throughout: SAME conv at stride 2 (HWIO), BiasAdd, Relu6,
    depthwise conv, SAME average pooling, VALID max pooling, fused batch
    norm, Mean, Reshape, MatMul, Softmax."""
    kern = rng.normal(0, 0.3, (3, 3, 2, 4)).astype(np.float32)
    dw = rng.normal(0, 0.3, (3, 3, 4, 2)).astype(np.float32)
    bn = [rng.uniform(0.5, 1.5, 8), rng.normal(0, 0.1, 8), rng.normal(0, 0.1, 8), rng.uniform(0.5, 1.5, 8)]
    w2 = rng.normal(0, 0.1, (8, 5)).astype(np.float32)

    def const(name, arr):
        return _tf_node(name, "Const", attrs=[_attr("value", _av_tensor(np.asarray(arr)))])

    def pool(name, op, src, k, s, pad):
        return _tf_node(name, op, [src], [_attr("ksize", _av_ints([1, k, k, 1])),
                                          _attr("strides", _av_ints([1, s, s, 1])),
                                          _attr("padding", _av_s(pad))])

    graph = b"".join([
        _tf_node("input", "Placeholder"), const("k", kern), const("b", rng.normal(0, 0.1, 4).astype(np.float32)),
        _tf_node("conv", "Conv2D", ["input", "k"], [_attr("strides", _av_ints([1, 2, 2, 1])),
                                                    _attr("padding", _av_s("SAME"))]),
        _tf_node("badd", "BiasAdd", ["conv:0", "b"]), _tf_node("r6", "Relu6", ["badd"]),
        const("dw", dw),
        _tf_node("dconv", "DepthwiseConv2dNative", ["r6", "dw"], [_attr("strides", _av_ints([1, 1, 1, 1])),
                                                                  _attr("padding", _av_s("SAME"))]),
        *[const(n, np.asarray(a, np.float32)) for n, a in zip(("g", "be", "mu", "va"), bn)],
        _tf_node("bn", "FusedBatchNormV3", ["dconv", "g", "be", "mu", "va"]),
        pool("ap", "AvgPool", "bn", 3, 2, "SAME"), pool("mp", "MaxPool", "ap", 2, 2, "VALID"),
        const("shape", np.asarray([-1, 8], np.int32)),
        _tf_node("flat", "Reshape", ["mp", "shape"]), const("w2", w2),
        _tf_node("fc", "MatMul", ["flat", "w2"]), _tf_node("prob", "Softmax", ["fc"]),
        const("axes", np.asarray([1, 2], np.int32)), _tf_node("gap", "Mean", ["bn", "axes"]),
    ])
    x = rng.normal(0, 1, (2, 9, 10, 2)).astype(np.float32)
    jnet = j_tf.load_tf(graph)
    jnet.set_input(x, "input")
    net = tf_importer.load_tf(graph, device="cpu")
    net.set_input(x, "input")
    with no_tf32():
        for out in ("prob", "gap", "ap"):
            _close(net.forward(out), jnet.forward(out))


def test_proto_copy_round_trips(rng):
    """The port's own protobuf codec writes the JAX codec's bytes and
    reads them back."""
    arr = rng.normal(0, 1, (2, 3)).astype(np.float32)
    body = proto.field_varint(1, 2) + proto.field_varint(1, 3) + proto.field_varint(2, 1) \
        + proto.field_str(8, "t") + proto.field_bytes(9, arr.tobytes()) + proto.field_varint(3, -1)
    assert body == (j_proto.field_varint(1, 2) + j_proto.field_varint(1, 3) + j_proto.field_varint(2, 1)
                    + j_proto.field_str(8, "t") + j_proto.field_bytes(9, arr.tobytes())
                    + j_proto.field_varint(3, -1))
    fields = proto.parse(body)
    np.testing.assert_array_equal(onnx_importer._tensor(fields), arr)
    assert proto.get_int(fields, 3) == -1
    assert struct.unpack("<f", proto.field_float(2, 1.5)[1:])[0] == 1.5
