"""The frozen generator gives the program's ``make_inputs`` bit for bit."""

import pytest
import torch

from _util import ROOT  # noqa: F401
from portbench.gen import scenarios


@pytest.mark.parametrize("seed", [0, 1])
def test_frozen_generator_matches_make_inputs(seed):
    import mav_tube_trajectory_generation_tpu_torch as mtg
    sc = mtg.make_inputs(10, 32, seed=seed, device="cpu")
    b = scenarios.make_batch(10, 32, seed)
    pairs = [(sc.waypoints, b["waypoints"]), (sc.times, b["times"]),
             (sc.radii, b["radii"]), (sc.values, b["values"]),
             (sc.d_fixed_free, b["d_fixed"])]
    for ours, frozen in pairs:
        assert ours.dtype == frozen.dtype
        assert torch.equal(ours, frozen)


def test_pool_is_seeded_and_distinct():
    cfg = {"n_segments": 10, "n_coefficients": 10,
           "segment_times": {"v_max": 3.0, "a_max": 5.0, "magic": 6.5}}
    tr = {"batch": 8, "pool": 3, "step_lo": 0.5, "step_hi": 2.0,
          "radii": {"kind": "constant", "value": 0.8}}
    a = scenarios.make_pool(cfg, tr, 3_000_000_123)
    b = scenarios.make_pool(cfg, tr, 3_000_000_123)
    c = scenarios.make_pool(cfg, tr, 3_000_000_124)
    assert all(torch.equal(x["waypoints"], y["waypoints"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["waypoints"], a[1]["waypoints"])
    assert not torch.equal(a[0]["waypoints"], c[0]["waypoints"])


def test_log_uniform_radii_follow_the_programs_tight_radii():
    import mav_tube_trajectory_generation_tpu_torch as mtg
    b = scenarios.make_batch(10, 16, 0, radii={"kind": "log_uniform",
                                               "lo": 0.05, "hi": 0.3})
    assert torch.equal(b["radii"], mtg.tight_radii(10, 16, device="cpu"))
