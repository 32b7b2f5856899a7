"""KITTI odometry and TUM RGB-D loaders (port of opencv_tpu/io/kitti.py,
host numpy; images through the port's `imread`).

Layout: sequences/<seq>/image_0/{000000.png,...}, calib.txt with
P0..P3 projection matrices, poses/<seq>.txt with 3x4 ground-truth poses
(cam0, world->... actually cam-to-world)."""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from opencv_tpu_torch.io.image import imread


class KittiOdometry:
    def __init__(self, root: str, sequence: str = "00", camera: int = 0):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.img_dir = os.path.join(self.seq_dir, f"image_{camera}")
        self.camera = camera
        self.frames = sorted(
            f for f in os.listdir(self.img_dir) if f.endswith((".png", ".pgm"))
        )
        self.K = self._load_calib()
        pose_file = os.path.join(root, "poses", f"{sequence}.txt")
        self.gt_poses = self._load_poses(pose_file) if os.path.exists(pose_file) else None

    def _load_calib(self) -> np.ndarray:
        calib = os.path.join(self.seq_dir, "calib.txt")
        with open(calib) as f:
            for line in f:
                if line.startswith(f"P{self.camera}:"):
                    vals = np.fromstring(line.split(":", 1)[1], sep=" ")
                    P = vals.reshape(3, 4)
                    return P[:, :3].astype(np.float32)
        raise ValueError(f"P{self.camera} not found in {calib}")

    @staticmethod
    def _load_poses(path: str) -> np.ndarray:
        """[N, 3, 4] cam-to-world matrices."""
        rows = np.loadtxt(path, dtype=np.float64)
        return rows.reshape(-1, 3, 4).astype(np.float32)

    def __len__(self) -> int:
        return len(self.frames)

    def image(self, i: int) -> np.ndarray:
        return imread(os.path.join(self.img_dir, self.frames[i]))

    def gt_centers(self) -> np.ndarray | None:
        """[N,3] camera centers (the translation column of cam-to-world)."""
        if self.gt_poses is None:
            return None
        return self.gt_poses[:, :, 3]

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self.image(i)


class TumRgbd:
    """TUM RGB-D: rgb.txt (timestamp path), groundtruth.txt
    (timestamp tx ty tz qx qy qz qw), nearest-timestamp association."""

    # default intrinsics for freiburg1/2/3 (TUM documentation)
    INTRINSICS = {
        "fr1": (517.3, 516.5, 318.6, 255.3),
        "fr2": (520.9, 521.0, 325.1, 249.7),
        "fr3": (535.4, 539.2, 320.1, 247.6),
    }

    def __init__(self, root: str, flavor: str = "fr1"):
        self.root = root
        fx, fy, cx, cy = self.INTRINSICS[flavor]
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.rgb = self._read_list(os.path.join(root, "rgb.txt"))
        gt_path = os.path.join(root, "groundtruth.txt")
        self.gt = (
            np.loadtxt(gt_path, comments="#", dtype=np.float64)
            if os.path.exists(gt_path)
            else None
        )

    @staticmethod
    def _read_list(path: str) -> list[tuple[float, str]]:
        out = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                out.append((float(ts), rel))
        return out

    def __len__(self) -> int:
        return len(self.rgb)

    def image(self, i: int) -> np.ndarray:
        return imread(os.path.join(self.root, self.rgb[i][1]))

    def gt_center_at(self, i: int) -> np.ndarray | None:
        """Ground-truth position nearest in time to frame i."""
        if self.gt is None:
            return None
        ts = self.rgb[i][0]
        j = int(np.argmin(np.abs(self.gt[:, 0] - ts)))
        return self.gt[j, 1:4].astype(np.float32)
