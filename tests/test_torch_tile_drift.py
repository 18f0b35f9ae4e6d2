"""tools/tile_drift.py on the CPU at a small replicate (susane x2, as
chip_smoke.py phase 25): every variant the CPU can run gives a finite
distance of tile 0 from the x1 run, and the warp-slice variants, which
need the kernels, are reported as the card's."""

import math

import pytest
import torch

from sph_sm_monodomain_tpu_torch.tools import tile_drift

SLICES = (2, 4, 16)


@pytest.fixture(scope="module")
def drift():
    """One torch thread: small ops, beside the suite's parallel workers
    (4 s alone, 86 s there with the full thread pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return tile_drift.drift("susane", replicates=(2,), steps=3,
                                slices=SLICES, device="cpu")
    finally:
        torch.set_num_threads(n)


def test_every_variant_is_listed(drift):
    want = (["x1 +1 ulp", "x1 -1 ulp", "x1 clustered (K = 1)"]
            + [f"x1 at {s} slices" for s in SLICES]
            + ["x1 in x2's world", "x1 clustered in x2's world",
               "x2 as built (blocked)", "x2 contig form", "x2 onehot form"]
            + [f"x2 at {s} slices" for s in SLICES])
    assert [v["label"] for v in drift["runs"]] == want


def test_cpu_variants_give_finite_distances(drift):
    assert drift["rows"] > 0 and drift["steps"] == 3
    assert 0.0 < drift["spread"] < 1e-4
    ran = [v for v in drift["runs"] if "skipped" not in v]
    assert len(ran) == 8
    for v in ran:
        assert math.isfinite(v["distance"]) and v["distance"] >= 0.0, v
        assert 0 <= v["row"] < drift["rows"] and len(v["at"]) == 3


def test_slice_variants_are_the_cards(drift):
    skipped = [v for v in drift["runs"] if "skipped" in v]
    assert [v["what"] for v in skipped] == ["slice count"] * 2 * len(SLICES)
    assert all("card" in v["skipped"] for v in skipped)
