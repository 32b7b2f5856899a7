"""A baseline JPEG decoder for what the repository's files hold, on the host
in numpy: the committed MJPEG clip (`benchmarks/data/megamind_gray.avi`)
and the one-component files that `imwrite` and `write_mjpeg_avi` produce.

The JAX package decodes every JPEG through PIL (`io/video.py`,
`io/image.py`); PIL's codec is libjpeg-turbo, whose default inverse DCT
is `JDCT_ISLOW` (`jidctint.c`), pure integer arithmetic. This decoder
reproduces that path step for step, so on the files it handles it gives
PIL's bytes exactly, without PIL:

- markers: SOI, APPn and COM (skipped), DQT (8- and 16-bit tables), SOF0
  with one component at any sampling (a one-component scan is
  non-interleaved: one block an MCU over ceil(W/8) x ceil(H/8) blocks)
  and SOF1 at 8 bits (libjpeg marks a file with 16-bit tables so; its
  Huffman coding is SOF0's), DHT, DRI with RST0-7, SOS, EOI;
- Huffman decoding through a 16-bit lookahead table per table over the
  unstuffed entropy bytes (every code is at most 16 bits), with DC
  prediction, ZRL and EOB, and the predictor reset at each restart;
- dequantisation in zig-zag order, then `jidctint.c`'s islow IDCT
  vectorised over every block in int64: CONST_BITS 13, PASS1_BITS 2, a
  round-half-up DESCALE by 11 after the column pass and by 18 after the
  row pass, the output masked with & 0x3FF and read through
  `range_limit`'s table (signed 10 bits, plus 128, clipped to 0-255);
- the crop of a frame that is not a multiple of 8 in either direction.

Any other file (progressive, arithmetic coding, 12-bit, more than one
component, any other SOF) is not handled here: `decode` raises
`Unsupported`, and the caller hands the file to PIL, as the JAX package
always does.
"""

from __future__ import annotations

import struct

import numpy as np


class Unsupported(ValueError):
    """The file uses a JPEG feature this decoder does not implement."""


# zig-zag index -> natural (row-major) index of the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# jidctint.c's constants: FIX(x) = round(x * 2^13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    """jidctint.c's DESCALE: x / 2^n rounded half up."""
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s: list, descale: int) -> list:
    """One pass of jpeg_idct_islow over the 8 inputs s[0..7] (arrays of
    the same shape, int64); returns the 8 outputs descaled by `descale`."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (s[0] + s[4]) << CONST_BITS
    tmp1 = (s[0] - s[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, descale) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients [N, 8, 8] (natural order) -> u8 samples
    [N, 8, 8], as jpeg_idct_islow computes them."""
    c = coef.astype(np.int64)
    cols = _idct_1d([c[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS)
    ws = np.stack(cols, axis=1)  # [N, 8 rows, 8 cols] after the column pass
    rows = _idct_1d([ws[:, :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3)
    out = np.stack(rows, axis=2) & 0x3FF
    out = np.where(out >= 512, out - 1024, out) + 128  # range_limit's table
    return np.clip(out, 0, 255).astype(np.uint8)


def _lookahead(bits: bytes, vals: bytes) -> tuple[list, list]:
    """DHT's code counts and symbols -> (symbol, code length) for every
    16-bit window; a window that starts no valid code has length 0."""
    sym = np.zeros(1 << 16, np.int64)
    length = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            lo = code << (16 - n)
            hi = lo + (1 << (16 - n))
            sym[lo:hi] = vals[k]
            length[lo:hi] = n
            code += 1
            k += 1
        code <<= 1
    return sym.tolist(), length.tolist()


def _unstuff(scan: bytes, pos: int) -> tuple[list[bytes], int]:
    """Entropy-coded bytes from `pos` up to the next marker that is not a
    restart: the segments between RST markers, each with its stuffed
    0xFF00 pairs and fill bytes removed. Returns (segments, position of
    the marker that ended the scan)."""
    segs, cur, n = [], bytearray(), len(scan)
    while pos < n:
        j = scan.find(b"\xff", pos)
        if j < 0:
            cur += scan[pos:]
            pos = n
            break
        cur += scan[pos:j]
        k = j + 1
        while k < n and scan[k] == 0xFF:  # fill bytes
            k += 1
        if k >= n:
            pos = n
            break
        m = scan[k]
        if m == 0x00:
            cur.append(0xFF)
            pos = k + 1
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            pos = k + 1
        else:
            pos = j
            break
    segs.append(bytes(cur))
    return segs, pos


def _windows(seg: bytes) -> list:
    """64-bit big-endian window starting at every byte of `seg` (zero
    padded past its end), as Python ints."""
    b = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.uint64)
    n = len(seg) + 1
    w = np.zeros(n, np.uint64)
    for i in range(8):
        w |= b[i:i + n] << np.uint64(56 - 8 * i)
    return w.tolist()


def _decode_blocks(seg: bytes, n_blocks: int, dc_tab, ac_tab, idx: list, val: list,
                   base: int) -> None:
    """Huffman-decode `n_blocks` blocks of one restart interval. Appends
    (flat zig-zag position, coefficient) pairs to idx/val, the DC as a
    running sum from a predictor of 0."""
    w = _windows(seg)
    dc_sym, dc_len = dc_tab
    ac_sym, ac_len = ac_tab
    nbits = 8 * len(seg)
    p, pred = 0, 0
    for blk in range(base, base + n_blocks):
        if p > nbits:
            raise ValueError("JPEG entropy data ended early")
        o = blk * 64
        look = (w[p >> 3] >> (48 - (p & 7))) & 0xFFFF
        n = dc_len[look]
        if n == 0:
            raise ValueError("bad DC Huffman code")
        s = dc_sym[look]
        p += n
        if s:
            v = (w[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            pred += v
        if pred:
            idx.append(o)
            val.append(pred)
        k = 1
        while k < 64:
            look = (w[p >> 3] >> (48 - (p & 7))) & 0xFFFF
            n = ac_len[look]
            if n == 0:
                raise ValueError("bad AC Huffman code")
            rs = ac_sym[look]
            p += n
            s = rs & 15
            if s == 0:
                if rs == 0xF0:  # ZRL
                    k += 16
                    continue
                break  # EOB
            k += rs >> 4
            v = (w[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            if k < 64:
                idx.append(o + k)
                val.append(v)
            k += 1


def decode(data: bytes) -> np.ndarray:
    """Baseline one-component JPEG -> u8 [H, W]. Raises `Unsupported` on
    a file that needs another decoder, ValueError on a broken one."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI)")
    qt: dict[int, np.ndarray] = {}
    huff: dict[tuple[int, int], tuple] = {}
    restart = 0
    frame = None
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        m = data[pos]
        pos += 1
        if m == 0xD9:  # EOI
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + seglen]
        pos += seglen
        if m == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq == 0:
                    qt[tq] = np.frombuffer(body, np.uint8, 64, i + 1).astype(np.int64)
                    i += 65
                else:
                    qt[tq] = np.frombuffer(body, ">u2", 64, i + 1).astype(np.int64)
                    i += 129
        elif m == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                total = sum(counts)
                huff[(tc, th)] = _lookahead(counts, body[i + 17:i + 17 + total])
                i += 17 + total
        elif m == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif m in (0xC0, 0xC1):  # SOF0, or SOF1 (the same coding, written with 16-bit tables)
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8 or nc != 1:
                raise Unsupported(f"SOF{m - 0xC0} with {prec}-bit samples and {nc} components")
            frame = (h, w, body[8])
        elif 0xC1 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise Unsupported(f"SOF{m - 0xC0} frame")
        elif m == 0xCC:
            raise Unsupported("arithmetic coding")
        elif m == 0xDA:  # SOS
            if frame is None:
                raise ValueError("SOS before SOF")
            if body[0] != 1:
                raise Unsupported("a scan of more than one component")
            td, ta = body[2] >> 4, body[2] & 15
            ss, se, ahal = body[3], body[4], body[5]
            if (ss, se, ahal) != (0, 63, 0):
                raise Unsupported("a spectral-selection or approximation scan")
            h, w, tq = frame
            bw, bh = (w + 7) // 8, (h + 7) // 8
            segs, pos = _unstuff(data, pos)
            n_blk = bw * bh
            per = restart if restart else n_blk
            idx: list[int] = []
            val: list[int] = []
            for r, seg in enumerate(segs):
                start = r * per
                if start >= n_blk:
                    break
                _decode_blocks(seg, min(per, n_blk - start), huff[(0, td)], huff[(1, ta)],
                               idx, val, start)
            zz = np.zeros(n_blk * 64, np.int64)
            zz[np.asarray(idx, np.int64)] = np.asarray(val, np.int64)
            zz = zz.reshape(n_blk, 64) * qt[tq][None, :]
            coef = np.zeros((n_blk, 64), np.int64)
            coef[:, ZIGZAG] = zz
            pix = idct_islow(coef.reshape(n_blk, 8, 8))
            img = pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
            return np.ascontiguousarray(img[:h, :w])
    raise ValueError("JPEG file without a scan")
