"""The per-leaf statistic of `chip_smoke.py`'s step checks (7a, 8b, 9b, 10b,
12b), on synthetic per-draw numbers: a leaf's error and noise are each the
RMS over the draws, the noise floored by the whole gradient's, and the check
holds the error within STEP_NOISE_FACTOR of the noise. Needs no card."""

import numpy as np
import pytest

import chip_smoke
from chip_smoke import GRAD_DRAWS, STEP_NOISE_FACTOR, leaf_noise_factor

NOISE = 1e-2


def _passes(errs, noises, floors):
    return leaf_noise_factor(errs, noises, floors)[2] <= STEP_NOISE_FACTOR


def test_one_bad_draw_of_four_passes():
    """A cancelling leaf at 3.5x its noise in one draw and 1x in three: the
    RMS over the draws is 1.95x, inside the bound, where one draw read alone
    would fail."""
    errs = [3.5 * NOISE, NOISE, NOISE, NOISE]
    noises = [NOISE] * 4
    floors = [NOISE / 10] * 4
    err, noise, factor = leaf_noise_factor(errs, noises, floors)
    assert noise == pytest.approx(NOISE)
    assert factor == pytest.approx(np.sqrt((3.5 ** 2 + 3) / 4))
    assert _passes(errs, noises, floors)
    assert not _passes(errs[:1], noises[:1], floors[:1])


def test_a_leaf_bad_in_every_draw_fails():
    errs = [3.5 * NOISE] * 4
    noises = [NOISE] * 4
    floors = [NOISE / 10] * 4
    assert leaf_noise_factor(errs, noises, floors)[2] == pytest.approx(3.5)
    assert not _passes(errs, noises, floors)


@pytest.mark.parametrize("err_factor,passes", [(2.0, True), (2.99, True), (4.0, False)])
def test_a_leaf_without_noise_takes_the_whole_gradient_floor(err_factor, passes):
    """A leaf whose bf16 run equals its f32 run in every draw (noise 0) is
    bounded by the RMS over draws of the whole gradient's noise."""
    floors = [0.5 * NOISE, 1.5 * NOISE, NOISE, NOISE]
    floor = float(np.sqrt(np.mean(np.square(floors))))
    errs = [err_factor * floor] * 4
    err, noise, factor = leaf_noise_factor(errs, [0.0] * 4, floors)
    assert noise == pytest.approx(floor)
    assert factor == pytest.approx(err_factor)
    assert _passes(errs, [0.0] * 4, floors) is passes


def test_the_step_checks_hold_leaves_over_four_draws_at_the_same_factor():
    assert GRAD_DRAWS == 4 and chip_smoke.LOSS_DRAWS >= GRAD_DRAWS
    assert STEP_NOISE_FACTOR == 3.0
