"""Simulation configuration (PyTorch port).

Field-for-field mirror of `sph_sm_monodomain_tpu.config`: every physical and
numerical constant of the reference engine is a field of a frozen, hashable
dataclass, and derived constants are properties so they cannot drift from
the primary fields. The mirror is pure Python; it does not import the JAX
package (whose `__init__` imports jax). tests/test_torch_config_state.py
holds the two to equality, field by field.

Reference provenance: the `SPH_SM_monodomain` constructor and header
defaults (SPH_SM_monodomain.cpp:13-79, SPH_SM_monodomain.h:72-94).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

m3Pi = math.pi  # the reference uses m3Pi = PI from m3Real.h


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All model constants for the coupled SPH + shape-matching + monodomain
    step. Defaults reproduce the reference constructor exactly."""

    # --- SPH core (cpp:17,29-49) ---
    kernel_h: float = 0.04                      # smoothing length h (cpp:17)
    world_size: Tuple[float, float, float] = (1.5, 1.5, 1.5)  # cpp:29
    cell_size: float = 0.04                     # hash-grid cell edge (cpp:31)
    gravity: Tuple[float, float, float] = (0.0, -9.8, 0.0)    # cpp:39
    k_stiffness: float = 0.5                    # EOS gas constant K (cpp:40)
    stand_density: float = 1112.0               # rest density rho0 (cpp:41)
    max_vel: Tuple[float, float, float] = (3.0, 3.0, 3.0)     # cpp:42 (CFL only)
    velocity_mixing: float = 1.0                # XSPH blend (cpp:43)
    wall_hit: float = -1.0                      # wall restitution (cpp:48)
    mu_viscosity: float = 100.0                 # dynamic viscosity (cpp:49)
    particle_mass: float = 0.2                  # per-particle mass (cpp:117)

    # --- Shape matching (cpp:59-69) ---
    sm_alpha: float = 0.3                       # velocity-correction stiffness (cpp:64)
    sm_beta: float = 0.4                        # linear/rotation blend (cpp:65)
    quadratic_match: bool = False               # cpp:67
    volume_conservation: bool = True            # cpp:68
    allow_flip: bool = False                    # cpp:69
    fixed_mass_scale: float = 100.0             # fixed particles weigh x100 in cm (cpp:247)
    # independent shape-matching clusters (multi-muscle scenes)
    sm_clusters: int = 1
    # rows per cluster for tile-contiguous layouts (0 = unknown)
    sm_tile_rows: int = 0
    jacobi_iterations: int = 20                 # m3Matrix.h JACOBI_ITERATIONS

    # --- Monodomain / FHN (cpp:15,23-27, h:72-80) ---
    cm_capacitance: float = 1.0                 # Cm (cpp:23)
    beta_sv_ratio: float = 50.0                 # surface/volume ratio Beta (cpp:24)
    sigma_i: float = 0.893                      # intracellular conductivity (cpp:15)
    sigma_e: float = 0.67                       # extracellular conductivity (cpp:15)
    stim_strength: float = 300.0                # cpp:27
    fh_vt: float = -75.0                        # FHN threshold voltage (h:72)
    fh_vp: float = 15.0                         # FHN peak voltage (h:73)
    fh_vr: float = -85.0                        # FHN rest voltage (h:74)
    fh_c1: float = 0.175                        # h:76
    fh_c2: float = 0.03                         # h:77
    fh_c3: float = 0.011                        # h:79
    fh_c4: float = 0.55                         # h:80
    voltage_constant: float = 1.0               # electromech coupling (h:92)
    max_pressure: float = 15000.0               # h:93
    max_voltage: float = 200.0                  # h:94

    # --- Integration (cpp:45-47) ---
    dt_cfl_factor: float = 0.4

    # --- Fidelity switches (reference quirks, each switchable) ---
    strict_reference_mode: bool = True
    # dens += m_i * Poly6(0) on top of the neighbor loop's self term (cpp:483)
    quirk_double_self_density: bool = True
    # pressure forced to -0.0 on particles with stim <= 0 (cpp:493-503)
    quirk_pressure_stim_gate: bool = True
    # Iion accumulated each step instead of assigned (cpp:589)
    quirk_iion_accumulate: bool = True
    # set_stim compares squared distance against an unsquared radius (cpp:712)
    quirk_stim_radius_squared: bool = True

    # --- Capacity / padding (replaces cpp:19 Max_Number_Paticles) ---
    max_particles: int = 50000
    # hash-grid bucket capacity; 0 = auto-size at scene build
    cell_capacity: int = 0

    # ----------------------------------------------------------------------
    @property
    def sigma(self) -> float:
        """Harmonic conductivity sigma_i*sigma_e/(sigma_i+sigma_e) (cpp:26)."""
        return self.sigma_i * self.sigma_e / (self.sigma_i + self.sigma_e)

    @property
    def time_delta(self) -> float:
        """CFL time step 0.4*h/|v_max| (cpp:47) ~= 3.0792e-3 s."""
        vmag = math.sqrt(sum(v * v for v in self.max_vel))
        return self.dt_cfl_factor * self.kernel_h / vmag

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """Cells per axis: ceil(world/cell) (cpp:32-35) = (38, 38, 38)."""
        return tuple(int(math.ceil(w / self.cell_size)) for w in self.world_size)

    @property
    def num_cells(self) -> int:
        gx, gy, gz = self.grid_size
        return gx * gy * gz

    @property
    def poly6_constant(self) -> float:
        """315/(64*pi*h^9) (cpp:54)."""
        return 315.0 / (64.0 * m3Pi * self.kernel_h ** 9)

    @property
    def spiky_constant(self) -> float:
        """45/(pi*h^6) (cpp:55)."""
        return 45.0 / (m3Pi * self.kernel_h ** 6)

    @property
    def b_spline_constant(self) -> float:
        """1/(pi*h^3) (cpp:57)."""
        return 1.0 / (m3Pi * self.kernel_h ** 3)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def add_viscosity(self, value: float) -> "SimConfig":
        """Runtime viscosity adjustment (add_viscosity, cpp:87-91): mu only
        changes when mu + value stays non-negative."""
        new_mu = self.mu_viscosity + (
            value if self.mu_viscosity + value >= 0 else 0.0)
        return self.replace(mu_viscosity=new_mu)

    def flip_quadratic(self) -> "SimConfig":
        """Toggle quadratic shape matching (h:154)."""
        return self.replace(quadratic_match=not self.quadratic_match)

    def flip_volume(self) -> "SimConfig":
        """Toggle volume conservation (h:155)."""
        return self.replace(volume_conservation=not self.volume_conservation)


DEFAULT_CONFIG = SimConfig()


def config_from_dict(d: dict) -> SimConfig:
    """SimConfig from a plain dict, e.g. `dataclasses.asdict` of the JAX
    package's config or a checkpoint's JSON snapshot. Lists become tuples;
    unknown keys raise."""
    fields = {f.name for f in dataclasses.fields(SimConfig)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(f"unknown SimConfig field(s) {unknown}")
    return SimConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in d.items()})


# Fields that may be overridden per call (`params`): consumed only in
# arithmetic, never in shapes, control flow or grid geometry. On the fused
# path they reach the sweep kernels through the physics-constant vector
# (ops.fused_step.build_dynp).
PARAM_FIELDS = frozenset({
    # SPH / mechanics (cpp:40-49)
    "k_stiffness", "stand_density", "mu_viscosity", "velocity_mixing",
    # shape matching (cpp:64-65)
    "sm_alpha", "sm_beta",
    # monodomain / FHN (cpp:15, 23-27, h:72-92)
    "sigma_i", "sigma_e", "cm_capacitance", "beta_sv_ratio",
    "fh_vt", "fh_vp", "fh_vr", "fh_c1", "fh_c2", "fh_c3", "fh_c4",
    "voltage_constant",
})


def resolve_params(cfg: SimConfig, params=None) -> SimConfig:
    """Overlay a dict of physics-parameter overrides (floats or 0-dim
    tensors) onto a config. Returns `cfg` unchanged when `params` is empty."""
    if not params:
        return cfg
    bad = sorted(set(params) - PARAM_FIELDS)
    if bad:
        raise ValueError(
            f"non-dynamic parameter(s) {bad}: only {sorted(PARAM_FIELDS)} "
            "may be overridden per call (geometry/capacity/quirk fields "
            "shape the step — set them on SimConfig instead)")
    return dataclasses.replace(cfg, **params)
