"""The roofline formulas against counts made by hand at a small size."""

import pytest

from portbench import roofline

KIND = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("camera_params,per_obs", [(6, 88), (9, 124)])
def test_cg_least_time(camera_params, per_obs):
    # per CG iteration: A's camera_params x 3 float32 block (72 B for 6, 108 B for BAL's 9)
    # and two int64 indices (16 B) per observation
    cg_iters, n_obs = 3, 5
    assert roofline.cg_bytes_per_obs(camera_params) == per_obs == camera_params * 3 * 4 + 2 * 8
    by_hand = cg_iters * n_obs * per_obs
    assert roofline.cg_least_s(cg_iters, n_obs, camera_params, KIND) == pytest.approx(by_hand / 3.35e12, rel=1e-12)


def test_unknown_card_has_no_roofline():
    with pytest.raises(KeyError):
        roofline.cg_least_s(1, 1, 6, "some other card")
