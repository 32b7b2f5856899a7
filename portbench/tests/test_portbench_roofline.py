"""The roofline formulas against counts made by hand at a small size."""

import pytest

from portbench import roofline

KIND = "NVIDIA H100 80GB HBM3"


def test_cg_least_time():
    # per CG iteration: A's 6x3 float32 block (72 B) and two int64 indices (16 B) per observation
    cg_iters, n_obs = 3, 5
    by_hand = cg_iters * n_obs * (6 * 3 * 4 + 2 * 8)
    assert roofline.cg_least_s(cg_iters, n_obs, KIND) == pytest.approx(by_hand / 3.35e12, rel=1e-12)


def test_unknown_card_has_no_roofline():
    with pytest.raises(KeyError):
        roofline.cg_least_s(1, 1, "some other card")
