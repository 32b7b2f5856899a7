"""Computational photography (port of opencv_tpu/ops/photo.py; the
reference `photo` module: fast non-local-means denoising, denoising.cpp;
inpainting, inpaint.cpp; HDR calibration, merging, tonemapping and MTB
alignment, calibrate.cpp, merge.cpp, tonemap.cpp, align.cpp; TV-L1
denoising, denoise_tvl1.cpp; decolor, decolor.cpp; seamless cloning,
seamless_cloning.cpp; the domain-transform NPR filters, npr.cpp).

The arithmetic is the JAX functions', operation for operation, with
every division by a device tensor (`true_div`). The JAX package's
`lax.fori_loop`s are Python loops here: XLA compiles their bodies whole
and may contract a multiply-add into an FMA, so the iterative filters
agree with it to a few f32 ulps a step. Where the JAX loops stop at a
fixed count but reach a fixed point early (Telea's distance bands), the
host stops at the fixed point: the later passes change nothing. The
domain transform's recurrences take JAX's own associative-scan order
(`_associative_scan`). Random draws (Debevec's pixel samples, decolor's
pixel pairs) come from a `torch.Generator` seeded with `seed`, or are
passed in: torch cannot replay `jax.random`.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_tpu_torch.core import imgproc
from opencv_tpu_torch.device import no_tf32, on_device, true_div
from opencv_tpu_torch.ops.distance import distance_transform

_BANDS_PER_CHECK = 8  # Telea distance bands per host read of "all filled"


def _image(img, device) -> torch.Tensor:
    return on_device(img, device).to(torch.float32)


def _laplacian4(x: torch.Tensor) -> torch.Tensor:
    """The four zero-filled neighbours summed as the JAX functions do:
    up + down + left + right."""
    return (imgproc.shift2d(x, -1, 0, 0.0) + imgproc.shift2d(x, 1, 0, 0.0)
            + imgproc.shift2d(x, 0, -1, 0.0) + imgproc.shift2d(x, 0, 1, 0.0))


def nl_means_denoise(img, h: float = 10.0, patch_size: int = 7, search_size: int = 21,
                     device=None) -> torch.Tensor:
    """Grayscale fast NLM (cv::fastNlMeansDenoising analog): for every
    search offset the patch SSD is one box sum of a squared-difference
    image. One row of offsets is shifted, box-summed and weighted as one
    batch; the weighted sums then accumulate offset by offset in the JAX
    order."""
    img = _image(img, device)
    r = search_size // 2
    acc = torch.zeros_like(img)
    wsum = torch.zeros_like(img)
    h2 = h * h * patch_size * patch_size
    ones = torch.ones_like(img)
    for dy in range(-r, r + 1):
        dxs = range(-r, r + 1)
        shifted = torch.stack([imgproc.shift2d(img, dy, dx, fill=0.0) for dx in dxs])
        valid = torch.stack([imgproc.shift2d(ones, dy, dx, fill=0.0) for dx in dxs])
        ssd = imgproc.box_sum_integral((img - shifted) ** 2, patch_size)
        w = torch.exp(true_div(-ssd, h2)) * valid  # out-of-image shifts do not vote
        contrib = w * shifted
        for i in range(len(dxs)):
            acc = acc + contrib[i]
            wsum = wsum + w[i]
    return acc / torch.clamp(wsum, min=1e-9)


def inpaint_diffusion(img, mask, iters: int = 300, device=None) -> torch.Tensor:
    """Fill masked pixels by harmonic (Laplace) diffusion from the
    boundary (the role of cv::inpaint)."""
    img = _image(img, device)
    known = ~on_device(mask, img.device).to(torch.bool)
    kf = known.to(torch.float32)
    fill = (img * kf).mean() / torch.clamp(kf.mean(), min=1e-9)
    x = torch.where(known, img, fill)
    for _ in range(iters):
        x = torch.where(known, img, 0.25 * _laplacian4(x))
    return x


def merge_mertens(images, contrast_w: float = 1.0, saturation_w: float = 1.0,
                  exposure_w: float = 1.0, device=None) -> torch.Tensor:
    """Exposure fusion (MergeMertens analog) for grayscale stacks
    [E, H, W] in [0, 255]; returns fused [H, W] in [0, 1]-ish scale.
    Single-scale weight blend."""
    x = true_div(_image(images, device), 255.0)
    lap = (4.0 * x - imgproc.shift2d(x, 0, 1, 0.0) - imgproc.shift2d(x, 0, -1, 0.0)
           - imgproc.shift2d(x, 1, 0, 0.0) - imgproc.shift2d(x, -1, 0, 0.0)).abs()
    wexp = torch.exp(true_div(-((x - 0.5) ** 2), 2 * 0.2 ** 2))
    w = (lap + 1e-6) ** contrast_w * wexp ** exposure_w
    w = w / torch.clamp(w.sum(0, keepdim=True), min=1e-9)
    return (w * x).sum(0)


def seamless_clone(src, dst, mask, iters: int = 400, device=None) -> torch.Tensor:
    """Poisson seamless cloning (cv::seamlessClone NORMAL_CLONE analog):
    Jacobi iteration of the Poisson equation inside the mask with the
    source's gradient field and the destination's boundary."""
    src = _image(src, device)
    dst = _image(dst, src.device)
    inside = on_device(mask, src.device).to(torch.bool)
    lap_src = (4.0 * src
               - imgproc.shift2d(src, -1, 0, 0.0) - imgproc.shift2d(src, 1, 0, 0.0)
               - imgproc.shift2d(src, 0, -1, 0.0) - imgproc.shift2d(src, 0, 1, 0.0))
    x = torch.where(inside, src, dst)
    for _ in range(iters):
        x = torch.where(inside, 0.25 * (_laplacian4(x) + lap_src), dst)
    return x


# ------------------------------------------------------------- HDR ---

def _hat(dev) -> torch.Tensor:
    k = torch.arange(256, device=dev)
    return torch.minimum(k, 255 - k).to(torch.float32) + 1.0


def calibrate_debevec(images, exposure_times, n_samples: int = 70, lam: float = 10.0,
                      seed: int = 0, idx=None, device=None) -> torch.Tensor:
    """Recover the log camera response g[256] from an exposure stack
    (CalibrateDebevec, photo/src/calibrate.cpp): the Debevec-Malik linear
    system g(Z_ij) - ln E_i = ln t_j with a second-difference smoothness
    prior and the hat weighting, g(128) = 0 gauge.

    images: u8-valued f32 [S, H, W]; exposure_times [S] seconds. `idx`
    ([n_samples] pixel indices, without repeats) are drawn from a
    generator seeded with `seed` unless given. The system is built in f32
    as the JAX function builds it and solved by QR in f64 (the JAX
    function takes an f32 SVD solve; the gauge row makes the system full
    rank)."""
    images = _image(images, device)
    dev = images.device
    s, h, w = images.shape
    if idx is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        idx = torch.randperm(h * w, generator=gen, device=dev)[:n_samples]
    idx = on_device(idx, dev).long()
    z = images.reshape(s, -1)[:, idx].to(torch.int64).clamp(0, 255)  # [S, P]
    n_unk = 256 + n_samples
    hat = _hat(dev)
    lnt = torch.log(on_device(exposure_times, dev).to(torch.float32))
    rows, rhs, wts = [], [], []
    p = torch.arange(n_samples, device=dev)
    for j in range(s):
        a = torch.zeros((n_samples, n_unk), dtype=torch.float32, device=dev)
        a[p, z[j]] = 1.0
        a[p, 256 + p] += -1.0
        rows.append(a)
        rhs.append(lnt[j].expand(n_samples))
        wts.append(hat[z[j]])
    # smoothness rows: lam * w(k) * (g[k-1] - 2 g[k] + g[k+1]) = 0
    ks = torch.arange(1, 255, device=dev)
    r = torch.arange(254, device=dev)
    sm = torch.zeros((254, n_unk), dtype=torch.float32, device=dev)
    sm[r, ks - 1] = 1.0
    sm[r, ks] = -2.0
    sm[r, ks + 1] = 1.0
    rows.append(sm)
    rhs.append(torch.zeros(254, device=dev))
    wts.append(lam * hat[ks])
    # gauge: g[128] = 0
    gauge = torch.zeros((1, n_unk), dtype=torch.float32, device=dev)
    gauge[0, 128] = 1.0
    rows.append(gauge)
    rhs.append(torch.zeros(1, device=dev))
    wts.append(torch.full((1,), 100.0, device=dev))

    wv = torch.sqrt(torch.cat(wts))
    A = torch.cat(rows) * wv[:, None]
    b = torch.cat(rhs) * wv
    sol = torch.linalg.lstsq(A.double(), b.double()[:, None], driver="gels").solution[:, 0]
    return sol[:256].float()  # log response g


def calibrate_robertson(images, exposure_times, iters: int = 8, device=None) -> torch.Tensor:
    """Robertson response recovery (CalibrateRobertson,
    photo/src/calibrate.cpp): alternate E-step (radiance from the current
    response) and M-step (response bin means), normalized at g[128]. The
    bin sums accumulate in f64 (the JAX function's f32 scatter sums in
    an order of its own)."""
    images = _image(images, device)
    dev = images.device
    s = images.shape[0]
    z = images.reshape(s, -1).to(torch.int64).clamp(0, 255)  # [S, P]
    zf = z.reshape(-1)
    t = on_device(exposure_times, dev).to(torch.float32)[:, None]
    wz = _hat(dev)[z]
    den = torch.zeros(256, dtype=torch.float64, device=dev).index_add_(
        0, zf, torch.ones(zf.shape[0], dtype=torch.float64, device=dev))
    g = true_div(torch.arange(256, dtype=torch.float32, device=dev), 128.0)  # linear init
    for _ in range(iters):
        e = (wz * g[z] * t).sum(0) / torch.clamp((wz * t * t).sum(0), min=1e-9)
        target = e[None, :] * t  # expected linear value per (s, p)
        num = torch.zeros(256, dtype=torch.float64, device=dev).index_add_(
            0, zf, target.reshape(-1).double())
        g_new = (num / torch.clamp(den, min=1e-9)).float()
        # monotone fill for empty bins: carry forward via cummax
        g_new = torch.cummax(torch.where(den > 0, g_new, torch.zeros_like(g_new)), 0).values
        g = g_new / torch.clamp(g_new[128], min=1e-9)
    return g


def merge_debevec(images, exposure_times, log_response, device=None) -> torch.Tensor:
    """HDR radiance map from the stack + log response (MergeDebevec,
    photo/src/merge.cpp): ln E = sum w(z)(g(z) - ln t) / sum w(z)."""
    images = _image(images, device)
    dev = images.device
    z = images.to(torch.int64).clamp(0, 255)  # [S, H, W]
    wz = _hat(dev)[z]
    lnt = torch.log(on_device(exposure_times, dev).to(torch.float32))[:, None, None]
    g = on_device(log_response, dev).to(torch.float32)
    ln_e = (wz * (g[z] - lnt)).sum(0) / torch.clamp(wz.sum(0), min=1e-9)
    return torch.exp(ln_e)


def tonemap_reinhard(hdr, gamma: float = 2.2, intensity: float = 0.18,
                     device=None) -> torch.Tensor:
    """Simple global Reinhard tonemap (TonemapReinhard analog) to u8 range."""
    hdr = _image(hdr, device)
    lw = torch.exp(torch.log(torch.clamp(hdr, min=1e-6)).mean())
    scaled = intensity * hdr / torch.clamp(lw, min=1e-9)
    ldr = scaled / (1.0 + scaled)
    return 255.0 * ldr.clamp(0.0, 1.0) ** (1.0 / gamma)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median of all elements: the mean of the two middle elements of
    an even count (torch.median takes the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    q = np.float32(0.5) * np.float32(s.shape[0] - 1)
    return (s[int(np.floor(q))] + s[int(np.ceil(q))]) * 0.5


def _mtb(img: torch.Tensor):
    med = _median(img)
    return img > med, (img - med).abs() > 4.0  # bitmap + exclusion


def align_mtb(images, max_shift: int = 16, device=None) -> torch.Tensor:
    """Median-threshold-bitmap alignment (AlignMTB, photo/src/align.cpp):
    translate every frame onto the first by maximizing MTB agreement over
    a coarse-to-fine shift pyramid. At each level the 9 (25 at the finest)
    candidate shifts are scored together and the host reads their errors
    once; the first candidate of least error wins, as the JAX function's
    chain of strict comparisons. Returns the aligned stack [S, H, W]."""
    images = _image(images, device)
    dev = images.device
    s, h, w = images.shape
    n_levels = max(1, int(np.ceil(np.log2(np.float32(max_shift)))))
    ref = images[0]
    out = [ref]
    for si in range(1, s):
        mov = images[si]
        shift = (0, 0)  # (dy, dx)
        for lvl in range(n_levels - 1, -1, -1):
            scale = 2 ** lvl
            rh, rw = max(h // scale, 8), max(w // scale, 8)
            rb, rm = _mtb(imgproc.resize_bilinear(ref, rh, rw))
            mb0, mm0 = _mtb(imgproc.resize_bilinear(mov, rh, rw))
            shift = (shift[0] * 2, shift[1] * 2)
            # finest level searches a wider window: the coarse levels'
            # bitmaps on downsampled images are only ~1px accurate
            radius = 2 if lvl == 0 else 1
            yy = torch.arange(rh, device=dev)[:, None]
            xx = torch.arange(rw, device=dev)[None, :]
            cands, errs = [], []
            for dy in range(-radius, radius + 1):
                for dx in range(-radius, radius + 1):
                    cy, cx = shift[0] + dy, shift[1] + dx
                    # zero-fill shift + validity: wrapped borders must not
                    # vote (align.cpp shifts with borderConstant)
                    bb = torch.roll(mb0, (cy, cx), (0, 1))
                    bm = torch.roll(mm0, (cy, cx), (0, 1))
                    ok = (yy - cy >= 0) & (yy - cy < rh) & (xx - cx >= 0) & (xx - cx < rw)
                    diff = (rb ^ bb) & rm & bm & ok
                    # +1/+1: among zero-disagreement candidates prefer the
                    # one with the most eligible (voting) overlap
                    errs.append((diff.sum() + 1.0) / ((rm & bm & ok).sum() + 1.0))
                    cands.append((cy, cx))
            err = torch.stack(errs).cpu().numpy()
            shift = cands[int(np.argmin(err))]
        out.append(torch.roll(mov, shift, (0, 1)))
    return torch.stack(out)


# --------------------------------------------------------------------------
# TV-L1 denoising (photo/src/denoise_tvl1.cpp:1)
# --------------------------------------------------------------------------


def denoise_tvl1(observations, lam: float = 1.0, n_iters: int = 30, device=None) -> torch.Tensor:
    """cv::denoise_TVL1 analog: primal-dual (Chambolle-Pock) minimization
    of  TV(x) + lam * sum_i |x - f_i|  over one or more noisy
    observations. Input/output in [0, 255] float."""
    if isinstance(observations, (list, tuple)):
        obs = torch.stack([_image(o, device) for o in observations])
    else:
        obs = _image(observations, device)
        if obs.ndim == 2:
            obs = obs[None]
    k = obs.shape[0]
    f = true_div(obs, 255.0)
    x0 = f[0]
    tau = sigma = 0.25
    theta = 1.0
    clip = lam * tau

    def grad(u):
        gx = torch.cat([u[:, 1:] - u[:, :-1], torch.zeros_like(u[:, :1])], 1)
        gy = torch.cat([u[1:, :] - u[:-1, :], torch.zeros_like(u[:1, :])], 0)
        return gx, gy

    def div(px, py):
        dx = px - torch.cat([torch.zeros_like(px[:, :1]), px[:, :-1]], 1)
        dy = py - torch.cat([torch.zeros_like(py[:1, :]), py[:-1, :]], 0)
        return dx + dy

    x, xbar = x0, x0
    px = torch.zeros_like(x0)
    py = torch.zeros_like(x0)
    for _ in range(n_iters):
        gx, gy = grad(xbar)
        px = px + sigma * gx
        py = py + sigma * gy
        mag = torch.clamp(torch.sqrt(px * px + py * py), min=1.0)
        px = px / mag
        py = py / mag
        v = x + tau * div(px, py)
        if k == 1:
            # exact single-observation prox: soft-shrink toward f
            d = v - f[0]
            x_new = f[0] + torch.sign(d) * torch.clamp(d.abs() - clip, min=0.0)
        else:
            # exact multi-observation prox of clip*sum_i |x - f_i| by
            # candidate enumeration: the minimizer is either inside a
            # sorted-f segment (v - clip*(2j - k)) or AT an observation
            cands = torch.stack([v - clip * (2 * j - k) for j in range(k + 1)]
                                + [f[i] for i in range(k)])  # [2k+1, H, W]
            obj = 0.5 * (cands - v) ** 2 + clip * (cands[:, None] - f[None]).abs().sum(1)
            x_new = torch.gather(cands, 0, obj.argmin(0)[None])[0]
        xbar = x_new + theta * (x_new - x)
        x = x_new
    return (x * 255.0).clamp(0.0, 255.0)


# --------------------------------------------------------------------------
# TELEA-style inpainting by distance-band marching (photo/src/inpaint.cpp:1)
# --------------------------------------------------------------------------


def inpaint_telea(img, mask, radius: float = 3.0, device=None) -> torch.Tensor:
    """cv::inpaint INPAINT_TELEA analog by distance bands: band k fills
    every pixel whose boundary distance is in (k-1, k], from
    already-known neighbours inside `radius`, weighted by Telea's
    direction x geometric-distance x level factors. The JAX function runs
    min(H, W) // 2 + 2 bands; here the host stops once every masked
    pixel is filled, after which a band changes nothing. The per-offset
    factors depend on the distance map alone and are computed once."""
    img = _image(img, device)
    dev = img.device
    mask = on_device(mask, dev) != 0
    dist = distance_transform(mask)  # 0 outside the hole
    h, w = img.shape[:2]
    max_bands = int(min(h, w) // 2 + 2)
    color = img.ndim == 3

    r = int(max(1, round(radius)))
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if (dy, dx) != (0, 0) and dy * dy + dx * dx <= r * r + 1e-6]
    # direction factor: alignment of the offset with grad(dist)
    gy = imgproc.shift2d(dist, -1, 0, fill=0.0) - imgproc.shift2d(dist, 1, 0, fill=0.0)
    gx = imgproc.shift2d(dist, 0, -1, fill=0.0) - imgproc.shift2d(dist, 0, 1, fill=0.0)
    gn = torch.sqrt(gx * gx + gy * gy) + 1e-6
    factors = []
    for dy, dx in offs:
        geo = 1.0 / (dy * dy + dx * dx)
        lev = 1.0 / (1.0 + (dist - imgproc.shift2d(dist, dy, dx, fill=0.0)).abs())
        dirf = (dy * gy + dx * gx).abs() / (gn * float((dy * dy + dx * dx) ** 0.5))
        factors.append((geo * lev) * (0.1 + dirf))

    x = torch.where(mask[..., None] if color else mask, torch.zeros_like(img), img)
    known = ~mask
    for k in range(max_bands):
        if k % _BANDS_PER_CHECK == 0 and bool(known.all()):
            break
        target = mask & (dist <= k + 1.0) & ~known
        num = torch.zeros_like(x)
        den = torch.zeros((h, w), dtype=torch.float32, device=dev)
        kf = known.to(torch.float32)
        for (dy, dx), fac in zip(offs, factors):
            wgt = imgproc.shift2d(kf, dy, dx, fill=0.0) * fac
            val = imgproc.shift2d(x, dy, dx, fill=0.0)
            num = num + (wgt[..., None] * val if color else wgt * val)
            den = den + wgt
        dn = torch.clamp(den, min=1e-9)
        est = num / (dn[..., None] if color else dn)
        fillable = target & (den > 1e-9)
        x = torch.where(fillable[..., None] if color else fillable, est, x)
        known = known | fillable
    return x


# --------------------------------------------------------------------------
# Contrast-preserving decolorization (photo/src/decolor.cpp:1)
# --------------------------------------------------------------------------


def _decolor_candidates() -> np.ndarray:
    """The simplex weights (wr, wg, wb) at 0.05 resolution, [231, 3]."""
    cand = []
    for wr in range(0, 21):
        for wg in range(0, 21 - wr):
            cand.append((wr / 20.0, wg / 20.0, (20 - wr - wg) / 20.0))
    return np.asarray(cand, np.float32)


def decolor(img_rgb, n_pairs: int = 4096, seed: int = 0, pairs=None, device=None):
    """cv::decolor analog (Lu, Xu & Jia 2012): choose the grayscale
    weights that best preserve colour contrast over a sample of pixel
    pairs, among all simplex weightings at 0.05 resolution. `pairs` (two
    [n_pairs] index arrays) are drawn from a generator seeded with `seed`
    unless given.

    Returns (gray [H,W] in [0,255], color_boost [H,W,3])."""
    img = true_div(_image(img_rgb, device), 255.0)
    dev = img.device
    flat = img.reshape(-1, 3)
    n = flat.shape[0]
    if pairs is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        pairs = [torch.randint(0, n, (n_pairs,), generator=gen, device=dev) for _ in range(2)]
    ia, ib = (on_device(p, dev).long() for p in pairs)
    ca, cb = flat[ia], flat[ib]  # [P, 3]
    # target contrast: euclidean colour difference (the reference's delta)
    d = ca - cb
    sqrt3 = torch.sqrt(torch.full((), 3.0, device=dev))
    delta = torch.sqrt((d * d).sum(1)) / sqrt3

    W = torch.as_tensor(_decolor_candidates(), device=dev)  # [C, 3]
    with no_tf32():
        gdiff = ca @ W.T - cb @ W.T  # [P, C]
    two_sig2 = torch.full((), 2 * 0.05 * 0.05, device=dev)
    # bimodal energy: each pair's gray difference should match +/- delta
    e = -torch.log(torch.exp(-((gdiff - delta[:, None]) ** 2) / two_sig2)
                   + torch.exp(-((gdiff + delta[:, None]) ** 2) / two_sig2) + 1e-12)
    wbest = W[int(e.sum(0).argmin())].cpu().numpy().astype(np.float64)
    gray = imgproc.channel_dot(img, wbest).clamp(0.0, 1.0)  # XLA's order of `img @ w`
    # colour boost: saturation-preserving recombination (the reference's
    # contrast_preserve boost output)
    lum = true_div(img.sum(2, keepdim=True), 3)
    boost = (img + (gray[..., None] - lum)).clamp(0.0, 1.0)
    return gray * 255.0, boost * 255.0


# --------------------------------------------------------------------------
# NPR: domain-transform filter family (photo/src/npr.cpp:1, npr.hpp)
# --------------------------------------------------------------------------


def _associative_scan(combine, elems: tuple, dim: int) -> tuple:
    """jax.lax.associative_scan over `dim` in its order: combine adjacent
    pairs, scan those recursively, combine back into the even positions,
    interleave."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.ndim
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = combine(tuple(sl(e, 0, -1, 2) for e in elems), tuple(sl(e, 1, None, 2) for e in elems))
    odd = _associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine(tuple(sl(e, 0, -1) for e in odd), tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = combine(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim) for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        shape = list(ev.shape)
        shape[dim] = ev.shape[dim] + od.shape[dim]
        res = ev.new_empty(shape)
        idx = [slice(None)] * ev.ndim
        idx[dim] = slice(0, None, 2)
        res[tuple(idx)] = ev
        idx[dim] = slice(1, None, 2)
        res[tuple(idx)] = od
        out.append(res)
    return tuple(out)


def _linear_combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _dt_recursive_1d(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Forward+backward recursive domain-transform pass along axis 1.
    x [H,W,C], v [H,W] feedback coefficients (a^ct). The recurrence
    y_j = (1-v_j) x_j + v_j y_{j-1} is a linear scan, evaluated in log
    depth in JAX's associative-scan order."""

    def lin_scan(xs, vs, reverse=False):
        if reverse:
            xs, vs = xs.flip(1), vs.flip(1)
        a = vs[..., None]
        aa, bb = _associative_scan(_linear_combine, (a, xs * (1.0 - a)), 1)
        out = bb + aa * xs[:, :1]
        return out.flip(1) if reverse else out

    # forward: v[0] must be 0 so y_0 = x_0
    vf = v.clone()
    vf[:, 0] = 0.0
    y = lin_scan(x, vf)
    # backward: shift v left (the reference's V[j+1] coupling on the
    # reverse pass) with v[last] = 0
    vb = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], 1)
    return lin_scan(y, vb, reverse=True)


def edge_preserving_filter(img_rgb, sigma_s: float = 60.0, sigma_r: float = 0.4,
                           n_iters: int = 3, device=None) -> torch.Tensor:
    """cv::edgePreservingFilter RECURS_FILTER analog (npr.cpp:52, the
    domain-transform recursive filter of npr.hpp:172-230): horizontal +
    vertical linear recurrences over a^(domain transform), 3 iterations
    with the standard shrinking sigma schedule."""
    src = _image(img_rgb, device)
    img = true_div(src, 255.0)
    if img.ndim == 2:
        img = img[..., None]
    # domain transforms (npr.hpp:397-460): ct = 1 + (s/r) * sum_c |d I|
    dx = (img[:, 1:] - img[:, :-1]).abs().sum(2)
    dy = (img[1:] - img[:-1]).abs().sum(2)
    ctx = torch.nn.functional.pad(dx, (1, 0)) * (sigma_s / sigma_r) + 1.0
    cty = torch.nn.functional.pad(dy, (0, 0, 1, 0)) * (sigma_s / sigma_r) + 1.0

    out = img
    for i in range(n_iters):
        sigma_h = (sigma_s * (3.0 ** 0.5) * (2.0 ** (n_iters - (i + 1)))
                   / ((4.0 ** n_iters - 1) ** 0.5))
        a = torch.exp(torch.full((), -(2.0 ** 0.5) / sigma_h, device=img.device))
        out = _dt_recursive_1d(out, a ** ctx)
        out = _dt_recursive_1d(out.transpose(0, 1), (a ** cty).T).transpose(0, 1)
    out = (out * 255.0).clamp(0.0, 255.0)
    return out[..., 0] if src.ndim == 2 else out


def detail_enhance(img_rgb, sigma_s: float = 10.0, sigma_r: float = 0.15,
                   device=None) -> torch.Tensor:
    """cv::detailEnhance (npr.cpp:70): base = DT filter; out = base +
    factor * (img - base), factor = 3."""
    img = _image(img_rgb, device)
    base = edge_preserving_filter(img, sigma_s, sigma_r)
    return (base + 3.0 * (img - base)).clamp(0.0, 255.0)


def _gradient(g: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.gradient along `dim` at unit spacing: central differences
    inside, one-sided at the two ends."""
    g = g.movedim(dim, 0)
    out = torch.cat([g[1:2] - g[0:1], (g[2:] - g[:-2]) * 0.5, g[-1:] - g[-2:-1]])
    return out.movedim(0, dim)


def _edge_magnitude(base: torch.Tensor) -> torch.Tensor:
    g = true_div(base.sum(-1), 3) if base.ndim == 3 else base
    gy, gx = _gradient(g, 0), _gradient(g, 1)
    return torch.sqrt(gx * gx + gy * gy)


def stylization(img_rgb, sigma_s: float = 60.0, sigma_r: float = 0.45,
                device=None) -> torch.Tensor:
    """cv::stylization (npr.cpp): DT-filtered base recombined with its
    own soft edge map for the posterized look."""
    img = _image(img_rgb, device)
    base = edge_preserving_filter(img, sigma_s, sigma_r)
    mag = _edge_magnitude(base)
    edge = (1.0 - mag / (mag.max() + 1e-6) * 4.0).clamp(0.0, 1.0)
    return (base * (edge[..., None] if base.ndim == 3 else edge)).clamp(0.0, 255.0)


def pencil_sketch(img_rgb, sigma_s: float = 60.0, sigma_r: float = 0.07,
                  shade_factor: float = 0.02, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cv::pencilSketch (npr.cpp): gray sketch from the DT-filter's
    residual structure + colour pencil = sketch-shaded input."""
    img = _image(img_rgb, device)
    base = edge_preserving_filter(img, sigma_s, sigma_r)
    mag = _edge_magnitude(base)
    scale = torch.full((), 255.0, device=img.device) / (mag.max() + 1e-6)
    sketch = (255.0 - mag * scale).clamp(0.0, 255.0)
    sketch = (sketch * (1.0 - shade_factor) + 255.0 * shade_factor).clamp(0, 255)
    shade = true_div(sketch[..., None] if img.ndim == 3 else sketch, 255.0)
    return sketch, (img * shade).clamp(0, 255)
