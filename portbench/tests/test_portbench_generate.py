"""The generator keeps each deployment's counts, and its scene keeps the
geometry that the configuration states."""

import json

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench.generate import make_problem, max_views, track_lengths

CONFIGS = {name: json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
           for name in ("kitti07-orbslam2", "kitti00-orbslam2")}
PROBLEMS = [(c, p) for c, cfg in CONFIGS.items() for p in cfg["problems"]]
# The sequences' frame counts (KITTI odometry), the frames each problem
# keeps, and ORB-SLAM2's KITTI extractor budget, 2000 features a frame,
# each an observation; 8 views a point on average.
KITTI_FRAMES = {"kitti07-orbslam2": (1101, 1101), "kitti00-orbslam2": (4541, 2000)}


@pytest.mark.parametrize("config,problem", PROBLEMS)
def test_counts_follow_the_deployment(config, problem):
    cfg = CONFIGS[config]
    c = cfg["problems"][problem]
    assert (cfg["sequence_frames"], cfg["frames"]) == KITTI_FRAMES[config]
    assert c["cameras"] == cfg["frames"] and c["observations"] == 2000 * cfg["frames"] == \
        cfg["features_per_frame"] * cfg["frames"]
    assert c["points"] * 8 == c["observations"]
    L = track_lengths(c["points"], c["observations"], cfg["layout"]["min_views"], max_views(cfg, c["cameras"]))
    assert len(L) == c["points"] and L.sum() == c["observations"] and L.min() >= 3
    assert L.max() <= max_views(cfg, c["cameras"]) < c["cameras"]


def _small(config, seed, cameras=200, points=500, observations=4000):
    cfg = dict(CONFIGS[config], problems={"p": {"cameras": cameras, "points": points,
                                                "observations": observations}})
    return cfg, make_problem(cfg, {"problem": "p"}, seed, "cpu")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_generated_problem(config):
    cfg, p = _small(config, 2**31 + 17)
    C, P, O = 200, 500, 4000
    assert p["cam_rvec"].shape == p["cam_tvec"].shape == (C, 3) and p["points"].shape == (P, 3)
    assert p["obs_cam"].shape == p["obs_pt"].shape == (O,) and p["obs_uv"].shape == (O, 2)
    views = torch.bincount(p["obs_pt"], minlength=P)
    assert views.sum() == O and views.min() >= 3
    # a track is a run of consecutive cameras around the loop, each seeing the point once
    cams = p["obs_cam"].view(-1)
    starts = torch.cumsum(views, 0) - views
    run = (cams - cams[starts].repeat_interleave(views)) % C
    assert torch.equal(run, torch.arange(O) - starts.repeat_interleave(views))
    assert bool((cams[starts + views - 1] < cams[starts]).any())  # some tracks close the loop
    assert torch.bincount(p["obs_cam"], minlength=C).min() > 0
    assert p["fixed_cams"].sum() == cfg["fixed_cameras"] and bool(p["fixed_cams"][:2].all())
    sorted_lengths = np.sort(views.numpy())
    assert (sorted_lengths == track_lengths(P, O, 3, max_views(cfg, C))).all()


def test_seed_decides_the_draws_not_the_sizes():
    _, a = _small("kitti07-orbslam2", 5)
    _, b = _small("kitti07-orbslam2", 5)
    _, d = _small("kitti07-orbslam2", 6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["obs_uv"], d["obs_uv"])
    assert torch.equal(torch.bincount(a["obs_pt"]).sort().values, torch.bincount(d["obs_pt"]).sort().values)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_points_lie_in_every_image_of_their_run(config):
    cfg, p = _small(config, 3, cameras=600, points=3000, observations=24000)
    cam = cfg["camera"]
    px = p["obs_uv"] * torch.tensor([cam["fx"], cam["fy"]]) + torch.tensor([cam["cx"], cam["cy"]])
    # within the image, but for the cameras' small rotations and 1 px noise
    slack = 0.03 * cam["fx"]
    assert float(px[:, 0].min()) > -slack and float(px[:, 0].max()) < cam["width"] + slack
    assert float(px[:, 1].min()) > -slack and float(px[:, 1].max()) < cam["height"] + slack


def test_runs_stay_within_the_scale_range():
    # (make_problem itself raises where a point's distances over its run span more than the scale range)
    cfg, p = _small("kitti00-orbslam2", 4, cameras=1000, points=3000, observations=24000)
    lay = cfg["layout"]
    assert int(torch.bincount(p["obs_pt"]).max()) <= max_views(cfg, 1000) == \
        1 + int(lay["far"] * (1 - 1 / lay["scale_range"]) // lay["spacing"])

