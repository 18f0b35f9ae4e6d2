"""Point clouds and state fields of the parity states, in numpy alone, so
that the card tests (tests/test_torch_cuda.py, run where there is no JAX)
build the same states with the port as tests/torch_parity.py builds with
the JAX package. Each function draws from the generator it is given, in a
fixed order."""

import numpy as np

WIDE_WORLD = (4.5, 1.5, 1.5)
BICEPS_CSV = "biceps_simple_out_18475.csv"


def blob_points(rng, n):
    """A Gaussian blob of n points around (0.6, 0.6, 0.6)."""
    return np.clip(rng.normal(size=(n, 3)).astype(np.float32) * 0.05 + 0.6,
                   0.05, 1.2)


def blob_fields(rng, cap, stand_density):
    """Random corrected velocities, voltages, recovery variables, currents
    and densities of `cap` rows."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(corrected_vel=f32(rng.normal(size=(cap, 3)) * 0.1),
                vm=f32(rng.normal(size=(cap,)) * 10.0),
                w=f32(rng.normal(size=(cap,)) * 1e-3),
                iion=f32(rng.normal(size=(cap,)) * 1e-3),
                dens=f32(stand_density + rng.normal(size=(cap,)) * 20.0))


def wide_points(rng):
    """220 points along x in the stretched world WIDE_WORLD (float64: the
    states take them as float32 and stimulate around the first, unrounded):
    the v4 / v5 hash axes permute (x is not the fast axis)."""
    return rng.random((220, 3)).astype(np.float32) * [4.3, 0.4, 0.4] \
        + [0.1, 0.5, 0.5]


def sparse_points(rng):
    """Two tight clusters far apart along the fast axis, so one sub-block
    straddles a huge hash gap and its dilated runs overlap
    (tests/test_pallas_sweeps.py:495-517)."""
    n = 96
    return np.concatenate([
        rng.random((n // 2, 3)).astype(np.float32) * 0.08 + 0.05,
        rng.random((n // 2, 3)).astype(np.float32) * 0.08 + 1.3,
    ]).astype(np.float32)
