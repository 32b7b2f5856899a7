"""Image and video I/O of the PyTorch port against the JAX package (and
PIL) on the CPU.

Tolerance: none anywhere. The port's baseline JPEG decoder
(`opencv_tpu_torch/io/_jpeg.py`) runs libjpeg-turbo's integer islow
IDCT, so on every one-component baseline file it equals PIL's decode
byte for byte: files PIL writes at quality 50, 90 and 100, with
optimized Huffman tables, with restart markers, with 16-bit
quantisation tables, at sizes that are not multiples of 8 (37x53, 9x17,
8x8, 1x1), and the committed clip `benchmarks/data/megamind_gray.avi`.
`read_mjpeg_avi` equals the JAX reader (which decodes through PIL) on
clip frames 0, 1, 50, 99 and 149 and on a file JAX's writer made, and
the SHA-256 of the JAX reader's first 100 frames is the constant
`chip_smoke.py` holds the card's decode to. `imread` of a gray JPEG
takes JAX's steps after the decode, so its f32 values are JAX's. The
Y4M, PNM and capture paths are plain host numpy and equal JAX's.
"""

import hashlib
import io
import os

import numpy as np
import pytest
from PIL import Image

from opencv_tpu.io import image as JI
from opencv_tpu.io import kitti as JK
from opencv_tpu.io import video as JV
from opencv_tpu_torch.io import _jpeg
from opencv_tpu_torch.io import image as TI
from opencv_tpu_torch.io import kitti as TK
from opencv_tpu_torch.io import video as TV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(REPO, "benchmarks", "data", "megamind_gray.avi")


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("L"))


def _texture(rng, h, w):
    """Smooth gradients plus noise: every coefficient band is busy."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    return np.clip(base + rng.normal(0, 25, (h, w)), 0, 255).astype(np.uint8)


SAVE_KW = {
    "q50": dict(quality=50),
    "q90": dict(quality=90),
    "q100": dict(quality=100),
    "optimize": dict(quality=90, optimize=True),
    "restart_blocks_2": dict(quality=90, restart_marker_blocks=2),
    "restart_rows_1": dict(quality=75, restart_marker_rows=1),
    "qtable_16bit": dict(qtables=[[300 + (i % 7) for i in range(64)]]),
}


@pytest.mark.parametrize("hw", [(37, 53), (8, 8), (9, 17), (64, 96), (1, 1)])
@pytest.mark.parametrize("kind", sorted(SAVE_KW))
def test_jpeg_decoder_equals_pil(rng, kind, hw):
    data = _pil_jpeg(_texture(rng, *hw), **SAVE_KW[kind])
    got = _jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == hw
    np.testing.assert_array_equal(got, _pil_decode(data))


def test_sixteen_bit_table_is_read():
    """The 16-bit DQT case really is 16-bit (Pq = 1)."""
    data = _pil_jpeg(np.zeros((8, 8), np.uint8), **SAVE_KW["qtable_16bit"])
    i = data.index(b"\xff\xdb")
    assert data[i + 4] >> 4 == 1


def test_idct_of_a_dc_block_is_flat():
    coef = np.zeros((1, 8, 8), np.int64)
    coef[0, 0, 0] = 8 * 40  # DC of a flat block 40 above mid-grey
    np.testing.assert_array_equal(_jpeg.idct_islow(coef), np.full((1, 8, 8), 168, np.uint8))


@pytest.mark.parametrize("kind", ["progressive", "colour"])
def test_other_jpeg_goes_to_pil(rng, kind):
    """A progressive or three-component file: the decoder refuses it, and
    `_jpeg_decode` (the AVI reader's) hands it to PIL as JAX does."""
    if kind == "progressive":
        data = _pil_jpeg(_texture(rng, 24, 40), quality=85, progressive=True)
    else:
        rgb = np.stack([_texture(rng, 24, 40)] * 3, axis=-1)
        data = _pil_jpeg(rgb, quality=85)
    with pytest.raises(_jpeg.Unsupported):
        _jpeg.decode(data)
    np.testing.assert_array_equal(TV._jpeg_decode(data), JV._jpeg_decode(data))


def test_read_mjpeg_avi_equals_jax_on_the_clip():
    got = TV.read_mjpeg_avi(CLIP)
    want = JV.read_mjpeg_avi(CLIP)
    assert got.shape == want.shape == (150, 528, 720) and got.dtype == want.dtype
    for f in (0, 1, 50, 99, 149):
        np.testing.assert_array_equal(got[f], want[f])
    np.testing.assert_array_equal(TV.read_mjpeg_avi(CLIP, max_frames=2), want[:2])


def test_clip_digest_is_chip_smokes_constant():
    """chip_smoke's [clip] holds the card's decode to this digest: the
    JAX reader's (PIL's) first 100 frames, uint8 [100, 528, 720], C order."""
    import chip_smoke

    frames = np.ascontiguousarray(JV.read_mjpeg_avi(CLIP)[:100])
    assert hashlib.sha256(frames.tobytes()).hexdigest() == chip_smoke.CLIP_SHA256


def test_read_mjpeg_avi_of_jax_written_file(tmp_path, rng):
    frames = np.stack([_texture(rng, 40, 56) for _ in range(3)])
    p = str(tmp_path / "clip.avi")
    JV.write_mjpeg_avi(p, frames, fps=10, quality=80)
    np.testing.assert_array_equal(TV.read_mjpeg_avi(p), JV.read_mjpeg_avi(p))
    q = str(tmp_path / "port.avi")
    TV.write_mjpeg_avi(q, frames, fps=10, quality=80)
    assert open(q, "rb").read() == open(p, "rb").read()


def test_y4m_roundtrip_equals_jax(tmp_path, rng):
    frames = rng.integers(0, 256, (5, 32, 48)).astype(np.uint8)
    p, q = str(tmp_path / "t.y4m"), str(tmp_path / "j.y4m")
    TV.write_y4m(p, frames, fps=30)
    JV.write_y4m(q, frames, fps=30)
    assert open(p, "rb").read() == open(q, "rb").read()
    back, fps = TV.read_y4m(q)
    assert fps == 30
    np.testing.assert_array_equal(back, frames)


def test_read_y4m_420_equals_jax(tmp_path, rng):
    """A C420 file: the luma planes come back, the chroma is skipped."""
    h, w = 16, 24
    p = str(tmp_path / "c.y4m")
    with open(p, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F24:1 Ip A1:1 C420jpeg\n".encode())
        for _ in range(2):
            f.write(b"FRAME\n" + rng.integers(0, 256, h * w * 3 // 2).astype(np.uint8).tobytes())
    (a, fa), (b, fb) = TV.read_y4m(p), JV.read_y4m(p)
    assert fa == fb == 24
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("magic", ["P5", "P6", "P5_16bit"])
def test_read_pnm_equals_jax(tmp_path, rng, magic):
    p = str(tmp_path / "im.pnm")
    if magic == "P5_16bit":
        arr = rng.integers(0, 65536, (7, 9)).astype(">u2")
        header = b"P5\n# a comment\n9 7\n65535\n"
    elif magic == "P5":
        arr = rng.integers(0, 256, (7, 9)).astype(np.uint8)
        header = b"P5 9 7 255\n"
    else:
        arr = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
        header = b"P6\n9 7\n255\n"
    with open(p, "wb") as f:
        f.write(header + arr.tobytes())
    got = TI._read_pnm(p)
    np.testing.assert_array_equal(got, JI._read_pnm(p))
    np.testing.assert_array_equal(TI.imread(p), JI.imread(p))
    np.testing.assert_array_equal(TI.imread(p, grayscale=False), JI.imread(p, grayscale=False))


@pytest.mark.parametrize("ext,channels", [(".png", 1), (".png", 3), (".jpg", 1), (".jpg", 3),
                                          (".pgm", 1)])
def test_imread_imwrite_equal_jax(tmp_path, rng, ext, channels):
    """imwrite then imread through both packages: equal files, equal f32
    arrays (gray JPEG through the port's decoder, the rest through PIL)."""
    img = _texture(rng, 30, 44).astype(np.float32)
    if channels == 3:
        img = np.stack([img, img[::-1], 255 - img], axis=-1)
    p, q = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    TI.imwrite(p, img)
    JI.imwrite(q, img)
    assert open(p, "rb").read() == open(q, "rb").read()
    for gray in (True, False):
        a, b = TI.imread(q, grayscale=gray), JI.imread(q, grayscale=gray)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_imread_gray_jpeg_uses_the_port_decoder(tmp_path, rng, monkeypatch):
    """A gray baseline JPEG never reaches PIL in the port."""
    p = str(tmp_path / "g.jpg")
    Image.fromarray(_texture(rng, 20, 28)).save(p, quality=90)
    want = JI.imread(p)
    import PIL.Image

    def refuse(*a, **k):
        raise AssertionError("PIL was asked to open a gray baseline JPEG")

    monkeypatch.setattr(PIL.Image, "open", refuse)
    np.testing.assert_array_equal(TI.imread(p), want)


def _capture_frames(cap):
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


@pytest.mark.parametrize("kind", ["y4m", "avi", "folder", "printf", "glob"])
def test_video_capture_equals_jax(tmp_path, rng, kind):
    frames = np.stack([_texture(rng, 24, 32) for _ in range(3)])
    if kind == "y4m":
        src = str(tmp_path / "c.y4m")
        JV.write_y4m(src, frames)
    elif kind == "avi":
        src = str(tmp_path / "c.avi")
        JV.write_mjpeg_avi(src, frames)
    else:
        d = tmp_path / "seq"
        d.mkdir()
        for i, f in enumerate(frames):
            Image.fromarray(f).save(str(d / f"{i:06d}.png"))
        src = {"folder": str(d), "printf": str(d / "%06d.png"), "glob": str(d / "*.png")}[kind]
    tc, jc = TV.VideoCapture(src), JV.VideoCapture(src)
    assert tc.is_opened() and tc.frame_count() == jc.frame_count() == 3
    got, want = _capture_frames(tc), _capture_frames(jc)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ext", [".y4m", ".avi"])
def test_video_writer_equals_jax(tmp_path, rng, ext):
    frames = [_texture(rng, 16, 24) for _ in range(3)]
    paths = []
    for mod, tag in ((TV, "t"), (JV, "j")):
        w = mod.VideoWriter(str(tmp_path / f"{tag}{ext}"), fps=5)
        for f in frames:
            w.write(f)
        w.release()
        paths.append(str(tmp_path / f"{tag}{ext}"))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert TV.VideoCapture(paths[1]).frame_count() == 3


def test_video_capture_rejects_unknown_source():
    with pytest.raises(ValueError):
        TV.VideoCapture("clip.mkv")


def _kitti_tree(root, rng):
    seq = root / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    for i in range(3):
        Image.fromarray(_texture(rng, 12, 20)).save(str(seq / "image_0" / f"{i:06d}.png"))
    P = rng.normal(size=(4, 12))
    with open(seq / "calib.txt", "w") as f:
        for c in range(4):
            f.write(f"P{c}: " + " ".join(f"{v:.6e}" for v in P[c]) + "\n")
    (root / "poses").mkdir()
    np.savetxt(root / "poses" / "00.txt", rng.normal(size=(3, 12)))


def test_kitti_odometry_equals_jax(tmp_path, rng):
    _kitti_tree(tmp_path, rng)
    for cam in (0, 2):
        if cam == 2:
            # camera 2 reads P2 from calib.txt; its images come from image_2
            src = tmp_path / "sequences" / "00" / "image_0"
            dst = tmp_path / "sequences" / "00" / "image_2"
            if not dst.exists():
                dst.mkdir()
                for f in os.listdir(src):
                    (dst / f).write_bytes((src / f).read_bytes())
        t, j = TK.KittiOdometry(str(tmp_path), "00", cam), JK.KittiOdometry(str(tmp_path), "00", cam)
        assert len(t) == len(j) == 3
        np.testing.assert_array_equal(t.K, j.K)
        np.testing.assert_array_equal(t.gt_poses, j.gt_poses)
        np.testing.assert_array_equal(t.gt_centers(), j.gt_centers())
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_kitti_without_poses(tmp_path, rng):
    _kitti_tree(tmp_path, rng)
    os.remove(tmp_path / "poses" / "00.txt")
    assert TK.KittiOdometry(str(tmp_path)).gt_centers() is None


def test_tum_rgbd_equals_jax(tmp_path, rng):
    (tmp_path / "rgb").mkdir()
    stamps = [1305031102.175304, 1305031102.211214, 1305031102.243211]
    with open(tmp_path / "rgb.txt", "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for i, ts in enumerate(stamps):
            Image.fromarray(_texture(rng, 10, 14)).save(str(tmp_path / "rgb" / f"{ts:.6f}.png"))
            f.write(f"{ts:.6f} rgb/{ts:.6f}.png\n")
    with open(tmp_path / "groundtruth.txt", "w") as f:
        f.write("# ground truth trajectory\n")
        for k in range(8):
            row = [stamps[0] - 0.01 + 0.012 * k] + list(rng.normal(size=7))
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    for flavor in ("fr1", "fr3"):
        t, j = TK.TumRgbd(str(tmp_path), flavor), JK.TumRgbd(str(tmp_path), flavor)
        np.testing.assert_array_equal(t.K, j.K)
        assert len(t) == len(j) == 3 and t.rgb == j.rgb
        for i in range(3):
            np.testing.assert_array_equal(t.image(i), j.image(i))
            np.testing.assert_array_equal(t.gt_center_at(i), j.gt_center_at(i))
