"""QR code detection and decoding, with a minimal encoder used as a test
fixture (port of opencv_tpu/ops/qrcode.py; reference
objdetect/src/qrcode.cpp: QRCodeDetector::detect and decode).

- Detection correlates the binarized (±1) image with the finder
  template at 9 module scales (per scale an s x s box sum and the
  dilated 7x7 finder, two `F.conv2d` with TF32 off, integer sums: the
  same scores on the card and the CPU, within ~1e-7 of the JAX
  package's), then NMS and a top-k of the peaks; the choice of three
  finders is host numpy.
- Decoding samples the module grid of versions 1-3 in one bilinear gather
  and reads it back once.
- The bit-level code (GF(256) arithmetic, Reed-Solomon, the format BCH,
  masks, the zig-zag, segment parsing) and the encoder are host numpy,
  copied from the JAX package.

QR structures follow the public ISO/IEC 18004 specification.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.core.types import masked_top_k
from opencv_tpu_torch.device import no_tf32, resolve_device

# ----------------------------------------------------------- GF(256) ---

_GF_EXP = np.zeros(512, np.int32)
_GF_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
_GF_EXP[255:510] = _GF_EXP[:255]


def _gf_mul(a, b):
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[_GF_LOG[a] + _GF_LOG[b]])


def _gf_poly_add(p, q):
    """XOR-add, right-aligned (lowest-order coefficients at the end)."""
    n = max(len(p), len(q))
    out = [0] * n
    for i, v in enumerate(p):
        out[n - len(p) + i] ^= v
    for i, v in enumerate(q):
        out[n - len(q) + i] ^= v
    return out


def _gf_poly_mul(p, q):
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] ^= _gf_mul(a, b)
    return out


def _rs_generator(nsym):
    g = [1]
    for i in range(nsym):
        g = _gf_poly_mul(g, [1, int(_GF_EXP[i])])
    return g


def rs_encode(data: list[int], nsym: int) -> list[int]:
    """Reed-Solomon parity symbols (QR convention, generator alpha^0..)."""
    gen = _rs_generator(nsym)
    rem = list(data) + [0] * nsym
    for i in range(len(data)):
        coef = rem[i]
        if coef:
            for j in range(1, len(gen)):
                rem[i + j] ^= _gf_mul(gen[j], coef)
    return rem[len(data):]


def rs_correct(codeword: list[int], nsym: int) -> list[int] | None:
    """Correct up to nsym//2 errors in-place; None when uncorrectable."""
    cw = list(codeword)
    synd = [0] * nsym
    for i in range(nsym):
        s = 0
        for c in cw:
            s = _gf_mul(s, int(_GF_EXP[i])) ^ c
        synd[i] = s
    if max(synd) == 0:
        return cw
    # Berlekamp-Massey
    err_loc = [1]
    old_loc = [1]
    for i in range(nsym):
        old_loc.append(0)
        delta = synd[i]
        for j in range(1, len(err_loc)):
            delta ^= _gf_mul(err_loc[-(j + 1)], synd[i - j])
        if delta:
            if len(old_loc) > len(err_loc):
                new_loc = [_gf_mul(delta, x) for x in old_loc]
                inv = _GF_EXP[255 - _GF_LOG[delta]]
                old_loc = [_gf_mul(int(inv), x) for x in err_loc]
                err_loc = new_loc
            err_loc = _gf_poly_add(
                err_loc, [_gf_mul(delta, x) for x in old_loc]
            )
    err_loc = err_loc[next((i for i, v in enumerate(err_loc) if v), 0):]
    n_err = len(err_loc) - 1
    if n_err * 2 > nsym:
        return None
    # Chien search
    n = len(cw)
    positions = []
    for i in range(n):
        xinv = int(_GF_EXP[(255 - (n - 1 - i)) % 255])
        v = 0
        for c in err_loc:
            v = _gf_mul(v, xinv) ^ c
        if v == 0:
            positions.append(i)
    if len(positions) != n_err:
        return None
    # error magnitudes via a small GF(256) Vandermonde solve (replaces
    # Forney — n_err <= nsym/2 is tiny):
    # sum_k e_k * (alpha^{n-1-pos_k})^i = synd[i]
    A = np.zeros((nsym, n_err), np.int32)
    for i in range(nsym):
        for k, p in enumerate(positions):
            A[i, k] = _GF_EXP[(i * (n - 1 - p)) % 255]
    # Gaussian elimination over GF(256)
    M = A.copy()
    s = np.asarray(synd, np.int32).copy()
    rows, cols = M.shape
    piv = []
    r = 0
    for c in range(cols):
        pr = None
        for rr in range(r, rows):
            if M[rr, c]:
                pr = rr
                break
        if pr is None:
            return None
        M[[r, pr]] = M[[pr, r]]
        s[[r, pr]] = s[[pr, r]]
        inv = int(_GF_EXP[255 - _GF_LOG[M[r, c]]])
        M[r] = [_gf_mul(int(v), inv) for v in M[r]]
        s[r] = _gf_mul(int(s[r]), inv)
        for rr in range(rows):
            if rr != r and M[rr, c]:
                f = int(M[rr, c])
                M[rr] = [int(v) ^ _gf_mul(f, int(w)) for v, w in zip(M[rr], M[r])]
                s[rr] = int(s[rr]) ^ _gf_mul(f, int(s[r]))
        piv.append(c)
        r += 1
        if r == cols:
            break
    mags = [int(s[i]) for i in range(n_err)]
    for k, p in enumerate(positions):
        cw[p] ^= mags[k]
    # verify
    for i in range(nsym):
        v = 0
        for c in cw:
            v = _gf_mul(v, int(_GF_EXP[i])) ^ c
        if v != 0:
            return None
    return cw


# ----------------------------------------------- format / layout maps ---

_FORMAT_MASK = 0b101010000010010
_EC_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}
# (data codewords, ecc codewords) per version at EC level L, 1 block
_VERSION_L = {1: (19, 7), 2: (34, 10), 3: (55, 15)}
_ALIGN_POS = {1: [], 2: [6, 18], 3: [6, 22]}


def _bch_format(bits5: int) -> int:
    g = 0b10100110111
    v = bits5 << 10
    for i in range(14, 9, -1):
        if v & (1 << i):
            v ^= g << (i - 10)
    return ((bits5 << 10) | v) ^ _FORMAT_MASK


def _function_mask(n: int, version: int) -> np.ndarray:
    """True where a module is a function pattern (not data)."""
    m = np.zeros((n, n), bool)
    for (r0, c0) in [(0, 0), (0, n - 7), (n - 7, 0)]:
        m[max(r0 - 1, 0):r0 + 8, max(c0 - 1, 0):c0 + 8] = True
    m[6, :] = True
    m[:, 6] = True
    # format info areas
    m[8, :9] = True
    m[:9, 8] = True
    m[8, n - 8:] = True
    m[n - 8:, 8] = True
    for cy in _ALIGN_POS[version]:
        for cx in _ALIGN_POS[version]:
            if (cy < 8 and cx < 8) or (cy < 8 and cx > n - 9) or (cy > n - 9 and cx < 8):
                continue
            m[cy - 2:cy + 3, cx - 2:cx + 3] = True
    return m


def _mask_fn(mask_id: int):
    return [
        lambda r, c: (r + c) % 2 == 0,
        lambda r, c: r % 2 == 0,
        lambda r, c: c % 3 == 0,
        lambda r, c: (r + c) % 3 == 0,
        lambda r, c: (r // 2 + c // 3) % 2 == 0,
        lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
        lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
        lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
    ][mask_id]


def _zigzag_positions(n: int, func_mask: np.ndarray):
    """Data-module (row, col) order per the spec's upward/downward zigzag."""
    out = []
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rng = range(n - 1, -1, -1) if upward else range(n)
        for r in rng:
            for c in (col, col - 1):
                if not func_mask[r, c]:
                    out.append((r, c))
        upward = not upward
        col -= 2
    return out


# ------------------------------------------------------------ encoder ---

def encode_qr(text: str, version: int = 2, mask_id: int = 0) -> np.ndarray:
    """Minimal QR encoder (byte mode, EC level L, versions 1-3): returns
    the module matrix bool [n, n] (True = dark). Exists as the decode
    test fixture; the reference ships no encoder either."""
    data_cw, ecc_cw = _VERSION_L[version]
    payload = text.encode("utf-8")
    if len(payload) > data_cw - 2:
        raise ValueError(
            f"payload {len(payload)}B exceeds version {version}-L byte "
            f"capacity ({data_cw - 2}B)"
        )
    bits = "0100" + format(len(payload), "08b")
    bits += "".join(format(b, "08b") for b in payload)
    bits += "0" * min(4, data_cw * 8 - len(bits))
    while len(bits) % 8:
        bits += "0"
    pads = ["11101100", "00010001"]
    k = 0
    while len(bits) < data_cw * 8:
        bits += pads[k % 2]
        k += 1
    data = [int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)]
    ecc = rs_encode(data, ecc_cw)
    codewords = data + ecc

    n = 17 + 4 * version
    mat = np.zeros((n, n), bool)
    func = _function_mask(n, version)
    # finders
    fin = np.zeros((7, 7), bool)
    fin[0, :] = fin[-1, :] = fin[:, 0] = fin[:, -1] = True
    fin[2:5, 2:5] = True
    for (r0, c0) in [(0, 0), (0, n - 7), (n - 7, 0)]:
        mat[r0:r0 + 7, c0:c0 + 7] = fin
    # timing
    mat[6, 8:n - 8] = (np.arange(8, n - 8) % 2) == 0
    mat[8:n - 8, 6] = (np.arange(8, n - 8) % 2) == 0
    # alignment (v2+)
    for cy in _ALIGN_POS[version]:
        for cx in _ALIGN_POS[version]:
            if (cy < 8 and cx < 8) or (cy < 8 and cx > n - 9) or (cy > n - 9 and cx < 8):
                continue
            a = np.zeros((5, 5), bool)
            a[0, :] = a[-1, :] = a[:, 0] = a[:, -1] = True
            a[2, 2] = True
            mat[cy - 2:cy + 3, cx - 2:cx + 3] = a
    # dark module
    mat[n - 8, 8] = True

    # data placement + mask
    mask = _mask_fn(mask_id)
    stream = "".join(format(cw, "08b") for cw in codewords)
    stream += "0" * (len(_zigzag_positions(n, func)) - len(stream))
    for bit, (r, c) in zip(stream, _zigzag_positions(n, func)):
        v = bit == "1"
        mat[r, c] = v ^ mask(r, c)

    # format info
    f = _bch_format((_EC_BITS["L"] << 3) | mask_id)
    fb = [(f >> i) & 1 for i in range(14, -1, -1)]
    coords_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
                (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    coords_b = [(n - 1, 8), (n - 2, 8), (n - 3, 8), (n - 4, 8), (n - 5, 8),
                (n - 6, 8), (n - 7, 8), (8, n - 8), (8, n - 7), (8, n - 6),
                (8, n - 5), (8, n - 4), (8, n - 3), (8, n - 2), (8, n - 1)]
    for bit, (r, c) in zip(fb, coords_a):
        mat[r, c] = bool(bit)
    for bit, (r, c) in zip(fb, coords_b):
        mat[r, c] = bool(bit)
    return mat


def render_qr(mat: np.ndarray, module_px: int = 6, quiet: int = 4) -> np.ndarray:
    """Module matrix -> grayscale image f32 (dark=0, light=255)."""
    n = mat.shape[0]
    big = np.kron(mat, np.ones((module_px, module_px), bool))
    out = np.full(
        ((n + 2 * quiet) * module_px, (n + 2 * quiet) * module_px), 255.0,
        np.float32,
    )
    q = quiet * module_px
    out[q:q + big.shape[0], q:q + big.shape[1]] = np.where(big, 0.0, 255.0)
    return out


# ----------------------------------------------------------- detector ---

_FINDER = np.ones((7, 7), np.float32)
_FINDER[1:6, 1:6] = -1
_FINDER[2:5, 2:5] = 1


def finder_scores(img: torch.Tensor, scales: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """(score [H, W], scale index [H, W]): the best correlation over the
    scales of the ±1 image (dark = +1, by Otsu) with the finder template,
    and the first scale reaching it (argmax's tie-break).

    The template at scale s is kron(finder, ones(s, s)) / (7s)^2, and the
    JAX function correlates with it directly. Here the same correlation
    is two `F.conv2d` calls: an s x s box sum of the zero-padded ±1 image,
    then the 7x7 ±1 finder dilated by s. Both sum small integers (exact
    in f32 in any order), and one division by the size follows, so the
    score is the correctly rounded value on the card and the CPU alike;
    XLA rounds as it sums, so the JAX scores differ by ~1e-7. (A direct
    84x84 correlation would also unfold into a multi-GB buffer on the
    CPU.)"""
    h, w = img.shape
    dev = img.device
    thr = imgproc.otsu_threshold(img)
    # <=: Otsu's split index is the last dark level of a two-level image
    binary = torch.where(img <= thr, 1.0, -1.0)[None, None]
    finder = torch.from_numpy(_FINDER).to(dev)[None, None]
    score = sidx = None
    with no_tf32():
        for k, s in enumerate(scales):
            pad = 7 * s // 2
            box = F.conv2d(F.pad(binary, (pad, pad, pad, pad)),
                           torch.ones((1, 1, s, s), dtype=torch.float32, device=dev))
            size = torch.tensor(float(49 * s * s), device=dev)
            # an even template emits H+1 x W+1: crop as the JAX function does
            sc = (F.conv2d(box, finder, dilation=s) / size)[0, 0, :h, :w]
            if score is None:
                score, sidx = sc, torch.zeros((h, w), dtype=torch.int64, device=dev)
            else:
                better = sc > score
                score = torch.where(better, sc, score)
                sidx = torch.where(better, k, sidx)
    return score, sidx


def detect_qr(img, scales: tuple[int, ...] = (2, 3, 4, 5, 6, 7, 8, 10, 12), max_peaks: int = 12,
              device=None) -> tuple[np.ndarray, bool]:
    """Locate the QR quadrangle (QRCodeDetector::detect analog). Returns
    (points [4, 2] f32: the TL, TR and BL finder centres and the inferred
    4th corner, ok). Finder peaks: NMS of radius 7 over the scores above
    0.72, the strongest `max_peaks`, one host read; then the three
    strongest mutually distant peaks on the host. Runs on the card unless
    `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    h, w = img.shape
    score, sidx = finder_scores(img, scales)
    peaks = imgproc.nms_2d(score, radius=7) & (score > 0.72)
    idx, keep = masked_top_k(score.reshape(-1), peaks.reshape(-1), max_peaks)
    host = torch.stack([idx, keep.to(torch.int64), sidx.reshape(-1)[idx]]).cpu().numpy()
    idx, ok, ss = host[0], host[1].astype(bool), host[2]

    xs = np.asarray(idx % w, np.float32)
    ys = np.asarray(idx // w, np.float32)
    pts = np.stack([xs, ys], 1)[ok]
    scl = np.asarray([scales[i] for i in ss[ok]], np.float32)
    if len(pts) < 3:
        return np.zeros((4, 2), np.float32), False

    # greedy: 3 strongest mutually-distant peaks with similar scale
    chosen = [0]
    for i in range(1, len(pts)):
        if all(np.linalg.norm(pts[i] - pts[j]) > 10 * scl[j] for j in chosen):
            chosen.append(i)
        if len(chosen) == 3:
            break
    if len(chosen) < 3:
        return np.zeros((4, 2), np.float32), False
    p = pts[chosen]

    # TL = the corner whose rays to the others are most orthogonal
    def ang(i):
        a, b = [j for j in range(3) if j != i]
        v1, v2 = p[a] - p[i], p[b] - p[i]
        c = v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-9)
        return abs(c)

    tl = int(np.argmin([ang(i) for i in range(3)]))
    others = [j for j in range(3) if j != tl]
    v1, v2 = p[others[0]] - p[tl], p[others[1]] - p[tl]
    # TR is the one making a right-handed (x right, y down) frame
    if v1[0] * v2[1] - v1[1] * v2[0] < 0:  # 2-D cross product z
        others = others[::-1]
    tr, bl = p[others[0]], p[others[1]]
    corner4 = tr + bl - p[tl]
    quad = np.stack([p[tl], tr, bl, corner4]).astype(np.float32)
    return quad, True


def _module_grid(tl, tr, bl, n: int) -> np.ndarray:
    """Module centres [n, n, 2] of a version with n modules per side, from
    the finder centres (3 modules in from the edges)."""
    ex = (tr - tl) / (n - 7)  # one module step along x
    ey = (bl - tl) / (n - 7)
    rows = np.arange(n) - 3.0
    cols = np.arange(n) - 3.0
    gx = tl[0] + cols[None, :] * ex[0] + rows[:, None] * ey[0]
    gy = tl[1] + cols[None, :] * ex[1] + rows[:, None] * ey[1]
    return np.stack([gx, gy], -1)


def decode_qr(img, quad: np.ndarray, device=None) -> str | None:
    """Decode the QR at `quad` (centres of the TL/TR/BL finders and the far
    corner): QRCodeDetector::decode analog, versions 1-3, byte and numeric
    modes. The three versions' module grids are sampled in one bilinear
    gather and read back once. Runs on the card unless `device="cpu"`."""
    img = torch.as_tensor(img, device=resolve_device(device)).to(torch.float32)
    tl, tr, bl = quad[0], quad[1], quad[2]
    sizes = [17 + 4 * version for version in (1, 2, 3)]
    grids = [_module_grid(tl, tr, bl, n).reshape(-1, 2) for n in sizes]
    xy = torch.as_tensor(np.concatenate(grids), dtype=torch.float32, device=img.device)
    flat = imgproc.bilinear_sample(img, xy).cpu().numpy()
    best = None
    start = 0
    for version, n in zip((1, 2, 3), sizes):
        vals = flat[start: start + n * n].reshape(n, n)
        start += n * n
        mat = vals < 0.5 * (vals.min() + vals.max())
        # timing pattern check picks the version
        t = mat[6, 8:n - 8]
        want = (np.arange(8, n - 8) % 2) == 0
        err = np.mean(t != want)
        if best is None or err < best[0]:
            best = (err, version, mat)
    err, version, mat = best
    if err > 0.25:
        return None
    n = 17 + 4 * version

    # format info (main copy): the nearest valid format word
    coords_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
                (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    fbits = 0
    for (r, c) in coords_a:
        fbits = (fbits << 1) | int(mat[r, c])
    best_fmt = None
    for ec in range(4):
        for mk in range(8):
            cand = _bch_format((ec << 3) | mk)
            dist = bin(cand ^ fbits).count("1")
            if best_fmt is None or dist < best_fmt[0]:
                best_fmt = (dist, ec, mk)
    _, _, mask_id = best_fmt

    func = _function_mask(n, version)
    mask = _mask_fn(mask_id)
    bits = []
    for (r, c) in _zigzag_positions(n, func):
        bits.append(int(mat[r, c]) ^ int(mask(r, c)))
    cw = [int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits) - 7, 8)]
    data_cw, ecc_cw = _VERSION_L[version]
    cw = cw[:data_cw + ecc_cw]
    fixed = rs_correct(cw, ecc_cw)
    if fixed is None:
        return None
    data = fixed[:data_cw]
    stream = "".join(format(b, "08b") for b in data)
    mode = stream[:4]
    if mode == "0100":  # byte
        cnt = int(stream[4:12], 2)
        payload = bytes(int(stream[12 + 8 * i:20 + 8 * i], 2) for i in range(cnt))
        try:
            return payload.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if mode == "0001":  # numeric
        cnt = int(stream[4:14], 2)
        pos = 14
        out = ""
        while len(out) < cnt:
            take = min(3, cnt - len(out))
            nb = {3: 10, 2: 7, 1: 4}[take]
            out += str(int(stream[pos:pos + nb], 2)).zfill(take)
            pos += nb
        return out
    return None
