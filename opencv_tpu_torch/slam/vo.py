"""Monocular visual odometry engine (port of opencv_tpu/slam/vo.py): ORB
front end -> Hamming matching -> two-view bootstrap (E-RANSAC + H-RANSAC
+ recoverPose + triangulation) -> per-frame frame-to-map P3P-RANSAC ->
keyframing + triangulation -> windowed bundle adjustment -> keyframe
retrieval, PnP verification and pose-graph relaxation.

Both trackers of the JAX engine are ported: "orb" re-detects and
re-matches every frame; "klt" tracks the keyframe's landmarks with
pyramidal LK (ops/lk.py) between keyframes, PnPs the tracked positions,
does descriptor work only at keyframes and falls back to ORB matching when
the track thins out.

Control (keyframe decisions, map bookkeeping, window compaction) runs in
host numpy exactly as in the JAX engine; every batch-numeric stage is a
function on device tensors, and the host reads each stage's results with
one fetch of a dict of tensors. The landmark map and the keyframe
descriptor database stay resident on the device and are re-uploaded only
when the host mirror changes.

`process_sequence` keeps the JAX engine's chunk semantics: frames of a
chunk track against the map as it stood when the chunk was dispatched.
They are tracked lazily, one frame at a time, so a chunk that restarts
early does no wasted work. With the "klt" tracker `process_sequence`
calls `process` per frame, as the JAX engine does.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from opencv_tpu_torch.core.config import LKConfig, MatchConfig, ORBConfig, RansacConfig
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.geometry import decompose, epipolar, homography as hom_mod, pnp
from opencv_tpu_torch.ops import lk, matching, orb
from opencv_tpu_torch.optim import ba
from opencv_tpu_torch.slam import loop_closure


# ---------------------------------------------------------------- host math


def _np_rodrigues(rvec: np.ndarray) -> np.ndarray:
    rvec = np.asarray(rvec, np.float64)
    theta2 = float(rvec @ rvec)
    x, y, z = rvec
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    k2 = k @ k
    if theta2 < 1e-8:
        a = 1.0 - theta2 / 6.0
        b = 0.5 - theta2 / 24.0
    else:
        theta = np.sqrt(theta2)
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / theta2
    return (np.eye(3) + a * k + b * k2).astype(np.float32)


def _np_rodrigues_inv(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, np.float64)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s2 = float(w @ w)
    theta = np.arctan2(np.sqrt(s2), tr - 1.0)
    if theta > np.pi - 1e-3:
        axis2 = np.clip((np.diag(R) + 1.0) * 0.5, 0.0, 1.0)
        axis = np.sqrt(axis2) * np.sign(np.where(w >= 0, 1.0, -1.0))
        return (axis * theta).astype(np.float32)
    scale = 0.5 + s2 / 24.0 if s2 < 1e-12 else theta / (2.0 * np.sin(theta) + 1e-30)
    return (w * scale).astype(np.float32)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask (np.median's mid-pair average); inf if empty."""
    n = mask.sum()
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    lo = xs[torch.clamp((n - 1) // 2, min=0)]
    hi = xs[torch.clamp(n // 2, min=0)]
    return torch.where(n > 0, 0.5 * (lo + hi), torch.full_like(lo, float("inf")))


def _to_dev_desc(desc: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(desc).view(np.int32)).to(dev)


def _fetch(out: dict) -> dict:
    """One host read of a stage's result bundle; descriptors come back as
    the JAX engine's uint32 words."""
    got = {k: v.cpu().numpy() for k, v in out.items()}
    if "desc" in got:
        got["desc"] = got["desc"].view(np.uint32)
    return got


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Field for field the JAX engine's VOConfig (same defaults)."""

    orb: ORBConfig = ORBConfig(n_features=1000)
    match: MatchConfig = MatchConfig(ratio=0.8, cross_check=True)
    tracker: str = "orb"  # "orb" or "klt" (LK between keyframes)
    lk: "LKConfig" = None
    klt_min_tracked: int = 40
    essential_threshold_px: float = 1.0
    pnp_threshold_px: float = 2.0
    bootstrap_parallax_px: float = 8.0
    triangulation_parallax_px: float = 12.0
    n_hypotheses: int = 1024
    min_init_features: int = 100
    bootstrap_max_frames: int = 40
    # kept for config parity: every engine RANSAC call runs the fixed
    # batch (adaptive=False), in the JAX engine as here
    ransac_adaptive: bool | None = None
    min_track_inliers: int = 30
    keyframe_min_inliers: int = 60
    keyframe_min_baseline: float = 0.12
    keyframe_decay_ratio: float = 0.5
    max_landmarks: int = 8192
    enable_loop_closure: bool = True
    loop_exclude_recent: int = 8
    loop_min_votes: int = 40
    loop_min_inliers: int = 30
    loop_cooldown: int = 5
    relocalize: bool = True
    window_size: int = 6
    window_landmark_cap: int = 2048
    ba_iters: int = 12
    min_parallax_depth: float = 120.0

    def __post_init__(self):
        if self.lk is None:
            object.__setattr__(self, "lk", LKConfig(n_levels=4))


class Keyframe:
    """Host-side keyframe record."""

    def __init__(self, frame_id, rvec, tvec, kp_xy, desc, kp_valid, landmark_idx):
        self.frame_id = frame_id
        self.rvec = rvec  # np [3]
        self.tvec = tvec  # np [3]
        self.kp_xy = kp_xy  # np [N,2] normalized coords
        self.desc = desc  # np [N,8] uint32
        self.kp_valid = kp_valid  # np [N]
        self.landmark_idx = landmark_idx  # np [N] i64, -1 = unassociated


# keys fetched for every tracked frame / only at keyframes and relocalization
_SMALL_KEYS = ("rvec", "tvec", "ok", "n_inl", "n_matches", "ti", "inl")
_BIG_KEYS = ("xy", "desc", "kvalid")


class _Stages:
    """The engine's batch-numeric stages on device tensors (the JAX
    engine's jitted kernels, vo.py:202-430)."""

    def __init__(self, cfg: VOConfig, K: np.ndarray, device: torch.device):
        self.cfg = cfg
        self.dev = device
        self.fx, self.fy, self.cx, self.cy = (float(K[0, 0]), float(K[1, 1]),
                                              float(K[0, 2]), float(K[1, 2]))
        f = (self.fx + self.fy) / 2.0
        self.pnp_thr = cfg.pnp_threshold_px / f
        self.huber = 3.0 / f
        self.pnp_cfg = RansacConfig(n_hypotheses=cfg.n_hypotheses, threshold=self.pnp_thr)
        self.e_cfg = RansacConfig(n_hypotheses=cfg.n_hypotheses,
                                  threshold=cfg.essential_threshold_px / f)
        self.depth_cap = float(cfg.min_parallax_depth)

    def norm_xy(self, xy):
        return torch.stack([(xy[:, 0] - self.cx) / self.fx, (xy[:, 1] - self.cy) / self.fy], 1)

    def detect(self, img):
        kp, desc = orb.detect_and_compute(img.to(torch.float32), config=self.cfg.orb)
        return {"xy": self.norm_xy(kp.xy), "desc": desc, "kvalid": kp.valid}

    def pnp_map(self, xy, desc, valid, lm_pos, lm_desc, lm_valid, gen):
        m = matching.knn_match(desc, lm_desc, query_valid=valid, train_valid=lm_valid,
                               config=self.cfg.match)
        res = pnp.solve_pnp_ransac(gen, lm_pos[m.train_idx], xy, valid=m.valid,
                                   adaptive=False, cfg=self.pnp_cfg)
        return {
            "ti": m.train_idx, "mv": m.valid, "n_matches": m.valid.sum(),
            "rvec": res.rvec, "tvec": res.tvec, "ok": res.ok,
            "n_inl": res.n_inliers, "inl": res.inliers,
        }

    def klt(self, prev, cur, px, pvalid, lm_idx, lm_pos, gen):
        """LK-track the track set from prev to cur, then PnP the tracked
        positions against their landmarks (the JAX engine's klt_k)."""
        new_px, status, _ = lk.calc_optical_flow_pyr_lk(prev, cur, px, pvalid, cfg=self.cfg.lk,
                                                        device=self.dev)
        st = status & pvalid
        res = pnp.solve_pnp_ransac(gen, lm_pos[lm_idx], self.norm_xy(new_px), valid=st,
                                   adaptive=False, cfg=self.pnp_cfg)
        return {
            "new_px": new_px, "st": st,
            "rvec": res.rvec, "tvec": res.tvec, "ok": res.ok,
            "n_inl": res.n_inliers, "inl": res.inliers,
        }

    def track(self, img, lm_pos, lm_desc, lm_valid, gen):
        det = self.detect(img)
        return {**det, **self.pnp_map(det["xy"], det["desc"], det["kvalid"],
                                      lm_pos, lm_desc, lm_valid, gen)}

    def boot(self, xy0, desc0, v0, xy1, desc1, v1, gen):
        """Two-view bootstrap: match + E-RANSAC + H-RANSAC + recoverPose +
        triangulation + per-H-candidate cheirality."""
        depth_cap = self.depth_cap
        m = matching.knn_match(desc0, desc1, query_valid=v0, train_valid=v1, config=self.cfg.match)
        xq = xy0[m.query_idx]
        xt = xy1[m.train_idx]
        med_disp = _masked_median(torch.linalg.vector_norm(xq - xt, dim=1), m.valid)
        eres = epipolar.find_essential_ransac(gen, xq, xt, valid=m.valid, adaptive=False,
                                              cfg=self.e_cfg)
        hres = hom_mod.find_homography_ransac(gen, xq, xt, valid=m.valid, cfg=self.e_cfg)
        rec = epipolar.recover_pose(eres.model, xq, xt, eres.inliers)
        h0 = torch.cat([xq, torch.ones_like(xq[:, :1])], dim=1)

        def rotflow_med(R, good):  # R [..., 3, 3], good [..., N]
            hr = h0 @ R.transpose(-1, -2)
            xr = hr[..., :2] / hr[..., 2:3].clamp(min=1e-9)
            d = torch.linalg.vector_norm(xt - xr, dim=-1)
            if d.dim() == 1:
                return _masked_median(d, good)
            return torch.stack([_masked_median(a, b) for a, b in zip(d, good)])

        t_e = rec.t / torch.linalg.vector_norm(rec.t).clamp(min=1e-12)
        X_e = epipolar.triangulate_normalized(rec.R, t_e, xq, xt)
        good_e = rec.mask & (X_e[:, 2] > 0.1) & (X_e[:, 2] < depth_cap)

        # H path: the 4 decompositions, parallax-aware cheirality support
        dec = decompose.decompose_homography(hres.model, torch.eye(3, device=self.dev))
        R, t = dec.R, dec.t
        tn = torch.linalg.vector_norm(t, dim=-1)
        tc = t / tn.clamp(min=1e-12)[:, None]
        Xh = epipolar.triangulate_normalized(R, tc, xq, xt)  # [4, N, 3]
        z1 = Xh[..., 2]
        z2 = (Xh @ R.transpose(-1, -2) + tc[:, None, :])[..., 2]
        C1 = -torch.einsum("cji,cj->ci", R, tc)
        r0 = Xh / torch.linalg.vector_norm(Xh, dim=-1, keepdim=True).clamp(min=1e-12)
        d1 = Xh - C1[:, None, :]
        r1 = d1 / torch.linalg.vector_norm(d1, dim=-1, keepdim=True).clamp(min=1e-12)
        par_ok = (r0 * r1).sum(-1) < float(np.cos(np.deg2rad(1.0)))
        usable = dec.valid & (tn > 1e-9)
        cheir = (z1 > 0) & (z2 > 0) & hres.inliers[None] & par_ok & usable[:, None]
        goodz = cheir & (z1 > 0.1) & (z1 < depth_cap)
        return {
            "qi": m.query_idx, "ti": m.train_idx, "mv": m.valid,
            "n_matches": m.valid.sum(), "med_disp": med_disp,
            "e_ok": eres.ok, "e_ninl": eres.n_inliers,
            "rec_R": rec.R, "rec_t": t_e, "rec_n_good": rec.n_good,
            "good_e": good_e, "n_good_e": good_e.sum(),
            "rotmed_e": rotflow_med(rec.R, good_e), "X_e": X_e,
            "h_ok": hres.ok, "h_ninl": hres.n_inliers,
            "h_count": cheir.sum(-1), "h_good": goodz, "h_n_good": goodz.sum(-1),
            "h_rotmed": rotflow_med(R, goodz), "h_R": R, "h_t": tc, "h_X": Xh,
        }

    def tri(self, desc0, v0, xy0, has0, desc1, v1, xy1, has1, R_rel, t_rel):
        """New-landmark triangulation between two keyframes."""
        thr = self.pnp_thr
        m = matching.knn_match(desc0, desc1, query_valid=v0, train_valid=v1, config=self.cfg.match)
        fresh = m.valid & ~has0[m.query_idx] & ~has1[m.train_idx]
        x0 = xy0[m.query_idx]
        x1 = xy1[m.train_idx]
        X0 = epipolar.triangulate_normalized(R_rel, t_rel, x0, x1)
        z0 = X0[:, 2]
        X1 = X0 @ R_rel.T + t_rel
        z1 = X1[:, 2]
        r0 = X0[:, :2] / z0[:, None].clamp(min=1e-9) - x0
        r1 = X1[:, :2] / z1[:, None].clamp(min=1e-9) - x1
        good = (
            fresh & (z0 > 0.1) & (z1 > 0.1) & (z0 < self.depth_cap)
            & ((r0 * r0).sum(1) < thr * thr) & ((r1 * r1).sum(1) < thr * thr)
        )
        return {"qi": m.query_idx, "ti": m.train_idx, "good": good, "X0": X0,
                "n_fresh": fresh.sum()}

    def verify(self, qxy, qdesc, qvalid, cpos, cdesc, cvalid, thr_v, gen):
        """Loop-closure / relocalization verification: match + PnP."""
        m = matching.knn_match(qdesc, cdesc, query_valid=qvalid, train_valid=cvalid,
                               config=MatchConfig(cross_check=False))
        res = pnp.solve_pnp_ransac(gen, cpos[m.train_idx], qxy, valid=m.valid, adaptive=False,
                                   cfg=RansacConfig(n_hypotheses=1024, threshold=thr_v))
        return {"n_matches": m.valid.sum(), "rvec": res.rvec, "tvec": res.tvec,
                "ok": res.ok, "n_inl": res.n_inliers}

    def retrieve(self, qdesc, qvalid, db_desc, db_valid, k_live):
        """Votes of keyframes [0, k_live) by ratio-tested matches over the
        flattened DB (64 keyframes x n_features: the streaming kernel)."""
        kcap = db_desc.shape[0]
        live = torch.arange(kcap, device=self.dev) < k_live
        m = matching.knn_match_auto(
            qdesc, db_desc.reshape(-1, 8), query_valid=qvalid,
            train_valid=(db_valid & live[:, None]).reshape(-1),
            config=MatchConfig(ratio=0.8, cross_check=False),
        )
        owner = m.train_idx // self.cfg.orb.n_features
        return torch.zeros(kcap, dtype=torch.int64, device=self.dev).index_add_(
            0, owner, m.valid.to(torch.int64))

    def ba(self, prob):
        return ba.bundle_adjust(prob, iters=self.cfg.ba_iters, huber_delta=self.huber)


class _Chunk:
    """Frames [base, base+K) of a staged clip, tracked against the map as
    it stood at dispatch; each frame is computed on first use."""

    def __init__(self, vo: "VisualOdometry", imgs: torch.Tensor):
        self.vo = vo
        self.imgs = imgs
        self.map = vo._device_map()
        self.det: dict[int, dict] = {}
        self.trk: dict[int, dict] = {}

    def detect(self, f: int) -> dict:
        if f not in self.det:
            self.det[f] = self.vo._stages.detect(self.imgs[f].to(torch.float32))
        return self.det[f]

    def track(self, f: int) -> dict:
        if f not in self.trk:
            d = self.detect(f)
            self.trk[f] = {**d, **self.vo._stages.pnp_map(
                d["xy"], d["desc"], d["kvalid"], *self.map, self.vo.gen)}
        return self.trk[f]

    def small(self, f: int) -> dict:
        out = self.track(f)
        return _fetch({k: out[k] for k in _SMALL_KEYS})

    def big(self, f: int) -> dict:
        out = self.detect(f)
        return _fetch({k: out[k] for k in _BIG_KEYS})


class VisualOdometry:
    """Monocular VO engine. Feed grayscale frames via `process` (or a clip
    via `process_sequence`); read `trajectory()` for per-frame camera
    centres (world frame). `device=None` runs on the card."""

    def __init__(self, K: np.ndarray, config: VOConfig = VOConfig(), seed: int = 0,
                 device=None):
        if config.tracker not in ("orb", "klt"):
            raise ValueError(f"unknown tracker {config.tracker!r}")
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float32)
        self.cfg = config
        f = float(self.K[0, 0] + self.K[1, 1]) / 2.0
        self._pnp_thr = config.pnp_threshold_px / f
        self._boot_parallax = config.bootstrap_parallax_px / f
        self._tri_parallax = config.triangulation_parallax_px / f
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.state = "init"  # init -> bootstrapping -> tracking
        self.frames = 0
        self.poses: list[tuple[np.ndarray, np.ndarray]] = []
        self.keyframes: list[Keyframe] = []
        m = config.max_landmarks
        self.lm_pos = np.zeros((m, 3), np.float32)
        self.lm_desc = np.zeros((m, 8), np.uint32)
        self.lm_valid = np.zeros((m,), bool)
        self.lm_anchor = np.full((m,), -1, np.int64)
        self._last_loop_kf = -(10 ** 9)
        self._kf_ref_inl = 0
        self._vote_log: list[tuple[int, np.ndarray]] = []
        self.loop_closures = 0
        self.relocalizations = 0
        self._map_dev = None
        self._map_dirty = True
        self._db_desc_dev = None  # [Kcap, N, 8] int32
        self._db_valid_dev = None  # [Kcap, N] bool
        self._db_count = 0
        self._preinit: list = []
        # klt tracker state: the previous frame on the device and the track
        # set (pixel positions, landmark ids, validity) in host numpy
        self._prev_img = None
        self._klt_px = np.zeros((config.orb.n_features, 2), np.float32)
        self._klt_lm = np.full(config.orb.n_features, -1, np.int64)
        self._klt_valid = np.zeros(config.orb.n_features, bool)
        self.lk_tracked = 0  # frames whose pose came from the LK track
        self._stages = _Stages(config, self.K, self.device)

    # ---------- device state caches ----------

    def _device_map(self):
        """Device copy of (lm_pos, lm_desc, lm_valid), re-uploaded only
        after a host-side map mutation."""
        if self._map_dev is None or self._map_dirty:
            dev = self.device
            self._map_dev = (
                torch.from_numpy(self.lm_pos.copy()).to(dev),
                _to_dev_desc(self.lm_desc, dev),
                torch.from_numpy(self.lm_valid.copy()).to(dev),
            )
            self._map_dirty = False
        return self._map_dev

    def _db_append(self, kf: Keyframe):
        """Append a keyframe's descriptors to the device retrieval DB
        (capacity grows in buckets of 64 keyframes, as in the JAX engine)."""
        n = self.cfg.orb.n_features
        dev = self.device
        if self._db_desc_dev is None or self._db_count >= self._db_desc_dev.shape[0]:
            pad_d = torch.zeros((64, n, 8), dtype=torch.int32, device=dev)
            pad_v = torch.zeros((64, n), dtype=torch.bool, device=dev)
            if self._db_desc_dev is None:
                self._db_desc_dev, self._db_valid_dev = pad_d, pad_v
            else:
                self._db_desc_dev = torch.cat([self._db_desc_dev, pad_d])
                self._db_valid_dev = torch.cat([self._db_valid_dev, pad_v])
        i = self._db_count
        self._db_desc_dev[i] = _to_dev_desc(kf.desc, dev)
        self._db_valid_dev[i] = torch.from_numpy(np.asarray(kf.kp_valid)).to(dev)
        self._db_count += 1

    # ---------- small helpers ----------

    def _t(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _alloc_landmarks(self, n: int) -> np.ndarray:
        return np.flatnonzero(~self.lm_valid)[:n]

    # ---------- pipeline stages ----------

    def _detect_frame(self, img_dev):
        det = _fetch(self._stages.detect(img_dev))
        return det["xy"], det["desc"], det["kvalid"]

    def _bootstrap(self, kf0: Keyframe, xy1, desc1, valid1, frame_id):
        """Two-view initialization from keyframe 0 to the current frame:
        one device stage, one fetch; the host only decides."""
        dev = self.device
        b = _fetch(self._stages.boot(
            self._t(kf0.kp_xy), _to_dev_desc(kf0.desc, dev), self._t(kf0.kp_valid),
            self._t(xy1), _to_dev_desc(desc1, dev), self._t(valid1), self.gen,
        ))
        if int(b["n_matches"]) < 50:
            return None
        if float(b["med_disp"]) < self._boot_parallax:
            return None
        if not bool(b["e_ok"]) or int(b["e_ninl"]) < 50:
            return None
        # H/E model selection (the ORB-SLAM recipe)
        e_decisive = int(b["rec_n_good"]) >= 0.9 * int(b["e_ninl"])
        use_h = (not e_decisive) or (
            bool(b["h_ok"]) and int(b["h_ninl"]) > 1.2 * int(b["e_ninl"])
        )
        out = None  # (R, t, good mask, X, rotmed, n_good)
        if use_h:
            counts = np.asarray(b["h_count"])
            order = np.argsort(-counts)
            best, second = int(counts[order[0]]), int(counts[order[1]])
            n_inl = int(b["h_ninl"])
            if best >= 50 and best >= 0.9 * n_inl and second <= 0.75 * best:
                c = int(order[0])
                out = (b["h_R"][c], b["h_t"][c], b["h_good"][c], b["h_X"][c],
                       float(b["h_rotmed"][c]), int(b["h_n_good"][c]))
        if out is None and e_decisive and int(b["rec_n_good"]) >= 40:
            out = (b["rec_R"], b["rec_t"], b["good_e"], b["X_e"],
                   float(b["rotmed_e"]), int(b["n_good_e"]))
        if out is None:
            return None
        R, t, good, X, rotmed, n_new = out
        if n_new < 30:
            return None
        if rotmed < self._tri_parallax:
            return None
        qi, ti = b["qi"], b["ti"]
        slots = self._alloc_landmarks(n_new)
        sel = np.flatnonzero(good)[: len(slots)]
        self.lm_pos[slots] = X[sel]
        self.lm_desc[slots] = desc1[ti[sel]]
        self.lm_valid[slots] = True
        self.lm_anchor[slots] = 0  # world frame == kf0 camera frame
        self._map_dirty = True
        kf0.landmark_idx[qi[sel]] = slots
        rvec1 = _np_rodrigues_inv(R)
        kf1 = Keyframe(frame_id, rvec1, np.asarray(t, np.float32), xy1, desc1, valid1,
                       np.full(xy1.shape[0], -1, np.int64))
        kf1.landmark_idx[ti[sel]] = slots
        self.keyframes.append(kf1)
        self._db_append(kf1)
        return rvec1, np.asarray(t, np.float32)

    def _denormalize(self, xy: np.ndarray) -> np.ndarray:
        return np.stack([xy[:, 0] * self.K[0, 0] + self.K[0, 2],
                         xy[:, 1] * self.K[1, 1] + self.K[1, 2]], axis=1)

    def _reseed_klt(self, kp_xy_norm, kp_valid, lm_idx):
        """Reset the track set to the landmark-associated keypoints."""
        n = self._klt_px.shape[0]
        sel = np.flatnonzero((lm_idx >= 0) & kp_valid)[:n]
        self._klt_px[:] = 0.0
        self._klt_lm[:] = -1
        self._klt_valid[:] = False
        self._klt_px[: sel.size] = self._denormalize(kp_xy_norm[sel])
        self._klt_lm[: sel.size] = lm_idx[sel]
        self._klt_valid[: sel.size] = True

    def _track_klt(self, img_dev):
        """LK-track the landmark set and PnP the new positions. Returns
        (rvec, tvec, n_inliers) or None (track too thin)."""
        if self._prev_img is None or self._klt_valid.sum() < self.cfg.klt_min_tracked:
            return None
        out = _fetch(self._stages.klt(
            self._prev_img, img_dev, self._t(self._klt_px),
            self._t(self._klt_valid & (self._klt_lm >= 0)), self._t(np.maximum(self._klt_lm, 0)),
            self._device_map()[0], self.gen,
        ))
        status = out["st"]
        if int(status.sum()) < self.cfg.klt_min_tracked:
            return None
        n_inl = int(out["n_inl"])
        if not bool(out["ok"]) or n_inl < self.cfg.min_track_inliers:
            return None
        # keep tracking inlier points only (outlier tracks have drifted)
        self._klt_px[:] = out["new_px"]
        self._klt_valid[:] = status & out["inl"]
        return out["rvec"], out["tvec"], n_inl

    def _track(self, xy, desc, valid):
        """Frame-to-map PnP from host-side detections (retro-localization)."""
        out = _fetch(self._stages.pnp_map(
            self._t(xy), _to_dev_desc(desc, self.device), self._t(valid),
            *self._device_map(), self.gen,
        ))
        return self._track_decide(out, xy.shape[0])

    def _track_decide(self, out, n_kp):
        """Shared host-side gate on a tracking bundle."""
        if int(out["n_matches"]) < self.cfg.min_track_inliers:
            return None
        n_inl = int(out["n_inl"])
        if not bool(out["ok"]) or n_inl < self.cfg.min_track_inliers:
            return None
        lm_idx = np.full(n_kp, -1, np.int64)
        inl = np.asarray(out["inl"])
        lm_idx[inl] = np.asarray(out["ti"])[inl]
        return out["rvec"], out["tvec"], n_inl, lm_idx

    def _need_keyframe(self, rvec, tvec, n_inl) -> bool:
        self._kf_ref_inl = max(self._kf_ref_inl, n_inl)
        kf_last = self.keyframes[-1]
        baseline = np.linalg.norm(
            self._camera_center(rvec, tvec) - self._camera_center(kf_last.rvec, kf_last.tvec)
        )
        scene_depth = np.median(self.lm_pos[self.lm_valid][:, 2]) if self.lm_valid.any() else 1.0
        return (
            n_inl < self.cfg.keyframe_min_inliers
            or n_inl < self.cfg.keyframe_decay_ratio * self._kf_ref_inl
            or baseline > self.cfg.keyframe_min_baseline * max(scene_depth, 1e-6)
        )

    def _maybe_keyframe(self, frame_id, rvec, tvec, xy, desc, valid, lm_idx, n_inl, force=False):
        if not (force or self._need_keyframe(rvec, tvec, n_inl)):
            return
        kf_last = self.keyframes[-1]
        kf = Keyframe(frame_id, rvec.copy(), tvec.copy(), xy, desc, valid, lm_idx.copy())
        self._triangulate_new(kf_last, kf)
        self.keyframes.append(kf)
        self._db_append(kf)
        self._kf_ref_inl = 0
        self._window_ba()
        if self.cfg.enable_loop_closure:
            self._try_loop_closure(len(self.keyframes) - 1)

    def _triangulate_new(self, kf0: Keyframe, kf1: Keyframe):
        """Create landmarks from unassociated matches between two KFs."""
        dev = self.device
        R0 = _np_rodrigues(kf0.rvec)
        R1 = _np_rodrigues(kf1.rvec)
        R_rel = R1 @ R0.T
        t_rel = kf1.tvec - R_rel @ kf0.tvec
        out = _fetch(self._stages.tri(
            _to_dev_desc(kf0.desc, dev), self._t(kf0.kp_valid), self._t(kf0.kp_xy),
            self._t(kf0.landmark_idx >= 0),
            _to_dev_desc(kf1.desc, dev), self._t(kf1.kp_valid), self._t(kf1.kp_xy),
            self._t(kf1.landmark_idx >= 0),
            self._t(R_rel, torch.float32), self._t(t_rel, torch.float32),
        ))
        sel = np.flatnonzero(out["good"])
        if sel.size == 0:
            return
        qi, ti, X_c0 = out["qi"], out["ti"], out["X0"]
        X_w = (X_c0[sel] - kf0.tvec) @ R0  # R0^T (X - t0)
        slots = self._alloc_landmarks(sel.size)
        n = len(slots)
        self.lm_pos[slots] = X_w[:n]
        self.lm_desc[slots] = kf1.desc[ti[sel[:n]]]
        self.lm_valid[slots] = True
        self.lm_anchor[slots] = len(self.keyframes)  # kf1's list index
        self._map_dirty = True
        kf0.landmark_idx[qi[sel[:n]]] = slots
        kf1.landmark_idx[ti[sel[:n]]] = slots

    def _window_ba(self):
        """Sliding-window BA over the last `window_size` keyframes, camera
        dimension padded with fixed dummies as in the JAX engine."""
        win = self.keyframes[-self.cfg.window_size:]
        C = len(win)
        if C < 3:
            return
        seen = np.unique(np.concatenate([kf.landmark_idx[kf.landmark_idx >= 0] for kf in win]))
        seen = seen[self.lm_valid[seen]][: self.cfg.window_landmark_cap]
        if seen.size < 20:
            return
        remap = -np.ones(self.cfg.max_landmarks, np.int64)
        remap[seen] = np.arange(seen.size)
        P = self.cfg.window_landmark_cap
        W = self.cfg.window_size
        O = W * self.cfg.orb.n_features
        obs_cam = np.zeros(O, np.int64)
        obs_pt = np.zeros(O, np.int64)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_valid = np.zeros(O, bool)
        o = 0
        for ci, kf in enumerate(win):
            idx = np.flatnonzero(kf.landmark_idx >= 0)
            li = remap[kf.landmark_idx[idx]]
            keep = li >= 0
            idx, li = idx[keep], li[keep]
            n = idx.size
            obs_cam[o : o + n] = ci
            obs_pt[o : o + n] = li
            obs_uv[o : o + n] = kf.kp_xy[idx]
            obs_valid[o : o + n] = True
            o += n
        pts = np.zeros((P, 3), np.float32)
        pts[: seen.size] = self.lm_pos[seen]
        fixed = np.ones(W, bool)
        fixed[:C] = False
        fixed[0] = True
        if C > 1:
            fixed[1] = True  # freeze gauge + scale
        cam_rv = np.zeros((W, 3), np.float32)
        cam_tv = np.zeros((W, 3), np.float32)
        cam_rv[:C] = np.stack([kf.rvec for kf in win])
        cam_tv[:C] = np.stack([kf.tvec for kf in win])
        prob = ba.BAProblem(
            cam_rvec=self._t(cam_rv), cam_tvec=self._t(cam_tv), points=self._t(pts),
            obs_cam=self._t(obs_cam), obs_pt=self._t(obs_pt), obs_uv=self._t(obs_uv),
            obs_valid=self._t(obs_valid), fixed_cams=self._t(fixed),
        )
        opt, _ = self._stages.ba(prob)
        got = _fetch({"rv": opt.cam_rvec, "tv": opt.cam_tvec, "pts": opt.points})
        for ci, kf in enumerate(win):
            kf.rvec = got["rv"][ci]
            kf.tvec = got["tv"][ci]
        self.lm_pos[seen] = got["pts"][: seen.size]
        self._map_dirty = True

    # ---------- loop closure & relocalization ----------

    def _candidate_landmarks(self, i, pad_to=2048):
        """Landmarks observed by keyframe i and its neighbours, padded."""
        lo, hi = max(0, i - 1), min(len(self.keyframes), i + 2)
        lm = np.unique(np.concatenate([self.keyframes[a].landmark_idx for a in range(lo, hi)]))
        lm = lm[lm >= 0]
        lm = lm[self.lm_valid[lm]][:pad_to]
        n = lm.size
        pos = np.zeros((pad_to, 3), np.float32)
        desc = np.zeros((pad_to, 8), np.uint32)
        val = np.zeros(pad_to, bool)
        pos[:n] = self.lm_pos[lm]
        desc[:n] = self.lm_desc[lm]
        val[:n] = True
        return pos, desc, val, n, lm

    def _retrieve(self, desc, valid, exclude_recent, return_votes=False):
        """Vote old keyframes against the device-resident DB."""
        k = len(self.keyframes) - exclude_recent
        if k < 1 or self._db_desc_dev is None:
            return ([], None) if return_votes else []
        votes = self._stages.retrieve(
            _to_dev_desc(desc, self.device), self._t(valid),
            self._db_desc_dev, self._db_valid_dev, min(k, self._db_count),
        ).cpu().numpy()
        order = np.argsort(-votes)
        out = [loop_closure.LoopCandidate(int(kf), int(votes[kf])) for kf in order[:3]
               if kf < k and votes[kf] >= self.cfg.loop_min_votes]
        return (out, votes) if return_votes else out

    def _verify(self, xy, desc, valid, pos, cdesc, cval, min_inliers, thr):
        """Match + PnP verification against candidate landmarks."""
        dev = self.device
        out = _fetch(self._stages.verify(
            self._t(xy), _to_dev_desc(desc, dev), self._t(valid),
            self._t(pos), _to_dev_desc(cdesc, dev), self._t(cval), float(thr), self.gen,
        ))
        if int(out["n_matches"]) < min_inliers:
            return None
        if not bool(out["ok"]) or int(out["n_inl"]) < min_inliers:
            return None
        return out["rvec"], out["tvec"], int(out["n_inl"])

    def _try_loop_closure(self, j):
        """On keyframe j's insertion: detect a revisit, verify it with PnP
        against the candidate's local map, relax the keyframe pose graph,
        and carry landmarks and past poses along."""
        cfg = self.cfg
        if j - self._last_loop_kf <= cfg.loop_cooldown:
            return
        if len(self.keyframes) <= cfg.loop_exclude_recent + 1:
            return
        kf = self.keyframes[j]
        cands, votes = self._retrieve(kf.desc, kf.kp_valid, cfg.loop_exclude_recent,
                                      return_votes=True)
        if votes is not None:
            self._vote_log.append((j, votes))
        cur_lm = set(kf.landmark_idx[kf.landmark_idx >= 0].tolist())
        for cand in cands:
            i = cand.kf_index
            pos, desc, val, n, lm_ids = self._candidate_landmarks(i)
            if n < cfg.loop_min_inliers:
                continue
            # covisibility exclusion: a candidate whose landmarks the query
            # still tracks is the same place, not a revisit
            if cur_lm:
                overlap = len(cur_lm.intersection(lm_ids.tolist())) / len(cur_lm)
                if overlap > 0.2:
                    continue
            # continuous-covisibility gate: a true revisit has a vote gap
            hist = [v[i] for (jj, v) in self._vote_log[:-1]
                    if jj >= i + cfg.loop_exclude_recent and i < len(v)]
            recent = hist[-6:]
            if len(recent) < 2 or min(recent) >= 0.5 * cfg.loop_min_votes:
                continue
            out = self._verify(kf.kp_xy, kf.desc, kf.kp_valid, pos, desc, val,
                               cfg.loop_min_inliers, self._pnp_thr)
            if out is None:
                continue
            rvec_q, tvec_q, _ = out
            loop_rel = loop_closure.relative_from_world_poses(
                self.keyframes[i].rvec, self.keyframes[i].tvec, rvec_q, tvec_q,
                device=self.device,
            )
            old_rv = np.stack([k.rvec for k in self.keyframes])
            old_tv = np.stack([k.tvec for k in self.keyframes])
            new_rv, new_tv = loop_closure.correct_poses(old_rv, old_tv, i, j, loop_rel,
                                                        device=self.device)
            self._apply_pose_correction(old_rv, old_tv, new_rv, new_tv)
            self._last_loop_kf = j
            self.loop_closures += 1
            return

    def _apply_pose_correction(self, old_rv, old_tv, new_rv, new_tv):
        """Move keyframes to corrected poses; carry each landmark with its
        anchor keyframe; remap the per-frame pose history."""
        R_old = np.stack([_np_rodrigues(r) for r in old_rv])
        R_new = np.stack([_np_rodrigues(r) for r in new_rv])
        for ci, kf in enumerate(self.keyframes):
            kf.rvec = new_rv[ci]
            kf.tvec = new_tv[ci]
        live = np.flatnonzero(self.lm_valid & (self.lm_anchor >= 0))
        if live.size:
            a = self.lm_anchor[live]
            Xc = np.einsum("nij,nj->ni", R_old[a], self.lm_pos[live]) + old_tv[a]
            self.lm_pos[live] = np.einsum("nji,nj->ni", R_new[a], Xc - new_tv[a])
            self._map_dirty = True
            kf_fids = np.array([k.frame_id for k in self.keyframes])
        for f in range(len(self.poses)):
            a = int(np.searchsorted(kf_fids, f, side="right")) - 1
            if a < 0:
                continue
            rv_f, tv_f = self.poses[f]
            Rrel = _np_rodrigues(rv_f) @ R_old[a].T
            trel = tv_f - Rrel @ old_tv[a]
            self.poses[f] = (_np_rodrigues_inv(Rrel @ R_new[a]),
                             (Rrel @ new_tv[a] + trel).astype(np.float32))

    def _relocalize(self, xy, desc, valid):
        """Tracking lost: retrieval over all keyframes + PnP verification."""
        for cand in self._retrieve(desc, valid, 0):
            pos, cdesc, val, n, _ = self._candidate_landmarks(cand.kf_index)
            if n < self.cfg.min_track_inliers:
                continue
            out = self._verify(xy, desc, valid, pos, cdesc, val,
                               self.cfg.min_track_inliers, 2.0 * self._pnp_thr)
            if out is not None:
                self.relocalizations += 1
                return out[0], out[1]
        return None

    # ---------- public API ----------

    @staticmethod
    def _camera_center(rvec, tvec):
        return -_np_rodrigues(rvec).T @ tvec

    def _extrapolate_pose(self):
        """Constant-velocity prediction from the last two poses."""
        if len(self.poses) < 2:
            return self.poses[-1]
        (rv1, tv1), (rv2, tv2) = self.poses[-2], self.poses[-1]
        R1 = _np_rodrigues(rv1)
        R2 = _np_rodrigues(rv2)
        R_rel = R2 @ R1.T
        t_rel = tv2 - R_rel @ tv1
        return _np_rodrigues_inv(R_rel @ R2), (R_rel @ tv2 + t_rel).astype(np.float32)

    def _new_kf0(self, frame_id, xy, desc, valid) -> Keyframe:
        return Keyframe(frame_id, np.zeros(3, np.float32), np.zeros(3, np.float32),
                        xy, desc, valid, np.full(xy.shape[0], -1, np.int64))

    def process(self, img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Process one grayscale frame; returns (rvec, tvec) world->cam."""
        img_dev = self._t(np.asarray(img, np.float32), torch.float32)
        frame_id = self.frames
        self.frames += 1
        klt = self.cfg.tracker == "klt"

        if self.state == "init":
            xy, desc, valid = self._detect_frame(img_dev)
            self._prev_img = img_dev
            if int(valid.sum()) < self.cfg.min_init_features:
                self.poses.append((np.zeros(3, np.float32), np.zeros(3, np.float32)))
                return self.poses[-1]
            kf = self._new_kf0(frame_id, xy, desc, valid)
            self.keyframes.append(kf)
            self._db_append(kf)
            self.poses.append((kf.rvec, kf.tvec))
            self.state = "bootstrapping"
            return kf.rvec, kf.tvec

        if self.state == "bootstrapping":
            xy, desc, valid = self._detect_frame(img_dev)
            out = self._bootstrap(self.keyframes[0], xy, desc, valid, frame_id)
            self._prev_img = img_dev
            if out is None:
                stale = frame_id - self.keyframes[0].frame_id
                if stale > self.cfg.bootstrap_max_frames and int(valid.sum()) >= self.cfg.min_init_features:
                    self.keyframes[0] = self._new_kf0(frame_id, xy, desc, valid)
                    if self._db_count > 0:
                        self._db_count = 0
                        self._db_append(self.keyframes[0])
                    self._preinit.clear()
                    self.poses.append(self.poses[-1])
                    return self.poses[-1]
                self._preinit.append((frame_id, xy, desc, valid))
                self.poses.append(self.poses[-1])
                return self.poses[-1]
            self.state = "tracking"
            self.poses.append(out)
            for fid, bxy, bdesc, bvalid in self._preinit:
                t2 = self._track(bxy, bdesc, bvalid)
                if t2 is not None:
                    self.poses[fid] = (t2[0], t2[1])
            self._preinit.clear()
            if klt:
                kf1 = self.keyframes[-1]
                self._reseed_klt(kf1.kp_xy, kf1.kp_valid, kf1.landmark_idx)
            return out

        # ---- tracking ----
        if klt:
            out = self._track_klt(img_dev)
            if out is not None:
                rvec, tvec, n_inl = out
                self.lk_tracked += 1
                self.poses.append((rvec, tvec))
                if self._need_keyframe(rvec, tvec, n_inl):
                    # descriptor work only at keyframes: detect, re-match
                    # to the map for landmark ids, keyframe, reseed
                    xy, desc, valid = self._detect_frame(img_dev)
                    t2 = self._track(xy, desc, valid)
                    if t2 is not None:
                        rvec, tvec, n_inl2, lm_idx = t2
                        self.poses[-1] = (rvec, tvec)
                        self._maybe_keyframe(frame_id, rvec, tvec, xy, desc, valid, lm_idx,
                                             n_inl2, force=True)
                        kf = self.keyframes[-1]
                        self._reseed_klt(kf.kp_xy, kf.kp_valid, kf.landmark_idx)
                self._prev_img = img_dev
                return self.poses[-1]
            # the LK track thinned out: fall through to the ORB matcher

        # fused detect + match + PnP, small fetch
        dev_out = self._stages.track(img_dev, *self._device_map(), self.gen)
        small = _fetch({k: dev_out[k] for k in _SMALL_KEYS})
        self._prev_img = img_dev
        out = self._track_decide(small, self.cfg.orb.n_features)
        if out is None:
            big = _fetch({k: dev_out[k] for k in _BIG_KEYS})
            rel = self._relocalize(big["xy"], big["desc"], big["kvalid"]) if self.cfg.relocalize else None
            self.poses.append(rel if rel is not None else self._extrapolate_pose())
            return self.poses[-1]
        rvec, tvec, n_inl, lm_idx = out
        self.poses.append((rvec, tvec))
        if self._need_keyframe(rvec, tvec, n_inl):
            big = _fetch({k: dev_out[k] for k in _BIG_KEYS})
            self._maybe_keyframe(frame_id, rvec, tvec, big["xy"], big["desc"], big["kvalid"],
                                 lm_idx, n_inl, force=True)
        if klt:
            src = self.keyframes[-1]
            self._reseed_klt(src.kp_xy, src.kp_valid, src.landmark_idx)
        return rvec, tvec

    def _seq_ingest(self, xy, desc, valid) -> bool:
        """init/bootstrap handling for one frame of process_sequence.
        Returns True when bootstrap just succeeded."""
        frame_id = self.frames
        self.frames += 1
        if self.state == "init":
            if int(valid.sum()) < self.cfg.min_init_features:
                self.poses.append((np.zeros(3, np.float32), np.zeros(3, np.float32)))
                return False
            kf = self._new_kf0(frame_id, xy, desc, valid)
            self.keyframes.append(kf)
            self._db_append(kf)
            self.poses.append((kf.rvec, kf.tvec))
            self.state = "bootstrapping"
            return False
        out = self._bootstrap(self.keyframes[0], xy, desc, valid, frame_id)
        if out is None:
            stale = frame_id - self.keyframes[0].frame_id
            if stale > self.cfg.bootstrap_max_frames and int(valid.sum()) >= self.cfg.min_init_features:
                self.keyframes[0] = self._new_kf0(frame_id, xy, desc, valid)
                self._db_count = 0
                self._db_append(self.keyframes[0])
            self.poses.append(self.poses[-1])
            return False
        self.state = "tracking"
        self.poses.append(out)
        return True

    def _seq_retro(self, dispatch, start: int, end: int):
        """PnP frames [start, end) against the fresh post-bootstrap map."""
        s = start
        while s < end:
            base, ch = dispatch(s)
            for f in range(s - base, min(end - base, ch.imgs.shape[0])):
                r = self._track_decide(ch.small(f), self.cfg.orb.n_features)
                if r is not None:
                    self.poses[base + f] = (r[0], r[1])
                s = base + f + 1

    def process_sequence(self, frames: np.ndarray, chunk: int = 8) -> np.ndarray:
        """Process a clip in chunks of `chunk` frames; keyframe, BA and
        loop-closure updates land at chunk granularity as in the JAX
        engine. The "klt" tracker runs `process` per frame, as the JAX
        engine does. Returns trajectory()."""
        if self.cfg.tracker == "klt":
            for f in frames:
                self.process(f)
            return self.trajectory()
        frames = np.asarray(frames)
        F = frames.shape[0]
        clip = np.clip(frames, 0, 255).astype(np.uint8)
        pad = (-F) % chunk
        if pad:
            clip = np.concatenate([clip, np.repeat(clip[-1:], pad, axis=0)])
        dev_clip = torch.from_numpy(clip).to(self.device)  # staged once, u8

        def dispatch(at):
            base = min(at, clip.shape[0] - chunk)
            return base, _Chunk(self, dev_clip[base : base + chunk])

        i = 0
        while i < F:
            base, ch = dispatch(i)
            off = i - base
            if self.state != "tracking":
                big = ch.big(off)
                became_tracking = self._seq_ingest(big["xy"], big["desc"], big["kvalid"])
                i += 1
                if became_tracking and i < F:
                    self._seq_retro(dispatch, self.keyframes[0].frame_id + 1, i - 1)
                continue
            for f in range(off, chunk):
                if i >= F:
                    break
                frame_id = self.frames
                self.frames += 1
                out = self._track_decide(ch.small(f), self.cfg.orb.n_features)
                if out is None:
                    big = ch.big(f)
                    rel = (self._relocalize(big["xy"], big["desc"], big["kvalid"])
                           if self.cfg.relocalize else None)
                    self.poses.append(rel if rel is not None else self._extrapolate_pose())
                    i += 1
                    continue
                rvec, tvec, n_inl, lm_idx = out
                self.poses.append((rvec, tvec))
                if self._need_keyframe(rvec, tvec, n_inl):
                    big = ch.big(f)
                    self._maybe_keyframe(frame_id, rvec, tvec, big["xy"], big["desc"],
                                         big["kvalid"], lm_idx, n_inl, force=True)
                    i += 1
                    if n_inl < self.cfg.keyframe_min_inliers:
                        # inlier-triggered keyframe: restart the chunk on the
                        # fresh map
                        break
                    continue
                i += 1
        return self.trajectory()

    def trajectory(self) -> np.ndarray:
        """[F,3] camera centres in world frame."""
        return np.stack([self._camera_center(rv, tv) for (rv, tv) in self.poses])
