"""Particle state: a dataclass of torch tensors (structure of arrays).

Mirror of `sph_sm_monodomain_tpu.state`: every field is a flat tensor over a
padded particle capacity, with an `active` mask for live rows. Checkpoints
use the JAX package's by-name npz schema (`field_<name>`, `__step__`,
`__config__`), so a state written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .config import SimConfig, config_from_dict

PAD_MULTIPLE = 128  # capacity granularity: one sweep sub-block


def _round_up(n: int, m: int = PAD_MULTIPLE) -> int:
    return ((n + m - 1) // m) * m


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. The port's entry points default to the
    card; a CUDA device that torch cannot see raises instead of falling
    back to the CPU, which a caller asks for with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but torch sees no "
                           "CUDA GPU; pass device=\"cpu\" to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle state (Particle.h:10-29 fields, padded + masked).

    Shapes: (N, 3) float32 for vectors, (N,) float32 for scalars, (N,) bool
    for `fixed` / `active`, and a 0-dim bool `is_stim_on` (h:68); N is the
    padded capacity."""

    pos: torch.Tensor            # Particle.h:10
    vel: torch.Tensor            # Particle.h:11
    predicted_vel: torch.Tensor  # Particle.h:12
    corrected_vel: torch.Tensor  # Particle.h:14
    inter_vel: torch.Tensor      # Particle.h:13
    acc: torch.Tensor            # Particle.h:15
    orig_pos: torch.Tensor       # Particle.h:18 (mOriginalPos)
    goal_pos: torch.Tensor       # Particle.h:19 (mGoalPos)
    mass: torch.Tensor           # Particle.h:16
    dens: torch.Tensor           # Particle.h:22
    pres: torch.Tensor           # Particle.h:23
    vm: torch.Tensor             # Particle.h:25 (Vm)
    inter_vm: torch.Tensor       # Particle.h:26
    iion: torch.Tensor           # Particle.h:27
    stim: torch.Tensor           # Particle.h:28
    w: torch.Tensor              # Particle.h:29
    fixed: torch.Tensor          # Particle.h:20 (mFixed), bool
    active: torch.Tensor         # live-row mask (replaces Number_Particles)
    is_stim_on: torch.Tensor     # 0-dim bool (h:68)

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def num_active(self) -> torch.Tensor:
        return self.active.sum()

    def displacement(self) -> torch.Tensor:
        """|orig_pos - pos| per particle (Particle.h:31-34 getDisplacement)."""
        return torch.linalg.vector_norm(self.orig_pos - self.pos, dim=-1)

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "ParticleState":
        return ParticleState(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


FIELD_NAMES = tuple(f.name for f in dataclasses.fields(ParticleState))
_BOOL_FIELDS = ("fixed", "active", "is_stim_on")


def init_fluid(positions, cfg: SimConfig, velocities=None,
               pad_to: int | None = None, device="cuda") -> ParticleState:
    """Seed a fluid from a point cloud (Init_Fluid / Init_Particle,
    cpp:93-125): capacity clamp at `cfg.max_particles` (cpp:103-104),
    vel = acc = 0, dens = rho0, mass = 0.2, EP fields zero, goal = orig =
    pos, nothing fixed. Padded rows sit far outside the world (they never
    hash into a grid cell) with `active=False`. The state lives on
    `device` (the card unless the caller asks for "cpu")."""
    device = resolve_device(device)
    positions = np.asarray(positions, dtype=np.float32)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (N, 3), got {positions.shape}")
    n = min(positions.shape[0], cfg.max_particles)  # capacity clamp cpp:103
    positions = positions[:n]
    if velocities is None:
        velocities = np.zeros_like(positions)
    else:
        velocities = np.asarray(velocities, dtype=np.float32)[:n]

    cap = pad_to if pad_to is not None else _round_up(max(n, 1))
    if cap < n:
        raise ValueError(f"pad_to={cap} smaller than particle count {n}")

    far = 4.0 * max(cfg.world_size)  # outside the grid (cpp:138-140)
    pos = np.full((cap, 3), far, dtype=np.float32)
    pos[:n] = positions
    vel = np.zeros((cap, 3), dtype=np.float32)
    vel[:n] = velocities
    active = np.zeros((cap,), dtype=bool)
    active[:n] = True

    f32 = dict(dtype=torch.float32, device=device)
    zeros3 = lambda: torch.zeros((cap, 3), **f32)   # noqa: E731
    zeros1 = lambda: torch.zeros((cap,), **f32)     # noqa: E731
    pos_t = torch.from_numpy(pos).to(device)
    return ParticleState(
        pos=pos_t,
        vel=torch.from_numpy(vel).to(device),
        predicted_vel=zeros3(),
        corrected_vel=zeros3(),
        inter_vel=zeros3(),
        acc=zeros3(),
        orig_pos=pos_t.clone(),
        goal_pos=pos_t.clone(),
        mass=torch.full((cap,), cfg.particle_mass, **f32),
        dens=torch.full((cap,), cfg.stand_density, **f32),
        pres=zeros1(),
        vm=zeros1(),
        inter_vm=zeros1(),
        iion=zeros1(),
        stim=zeros1(),
        w=zeros1(),
        fixed=torch.zeros((cap,), dtype=torch.bool, device=device),
        active=torch.from_numpy(active).to(device),
        is_stim_on=torch.tensor(False, device=device),
    )


def state_from_numpy(arrays: dict, device="cuda") -> ParticleState:
    """ParticleState on `device` from a dict of arrays keyed by field name
    (e.g. the fields of a JAX-package state taken through `np.asarray`).
    Missing or unknown fields raise; float fields become float32, flags
    bool."""
    device = resolve_device(device)
    missing = [n for n in FIELD_NAMES if n not in arrays]
    unknown = sorted(set(arrays) - set(FIELD_NAMES))
    if missing or unknown:
        raise ValueError(f"state field mismatch — missing {missing}, "
                         f"unknown {unknown}")
    out = {}
    for name in FIELD_NAMES:
        a = np.asarray(arrays[name])
        a = a.astype(bool if name in _BOOL_FIELDS else np.float32,
                     copy=False)
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    state = ParticleState(**out)
    cap = state.pos.shape[0]
    bad = [n for n in FIELD_NAMES if getattr(state, n).ndim >= 1
           and getattr(state, n).shape[0] != cap]
    if state.pos.ndim != 2 or state.pos.shape[1] != 3 or bad:
        raise ValueError(f"inconsistent field shapes (capacity axis {cap}, "
                         f"pos {tuple(state.pos.shape)}, mismatched {bad})")
    return state


def state_to_numpy(state: ParticleState) -> dict:
    """{field name: numpy array} on the host (the inverse of
    `state_from_numpy`)."""
    return {n: getattr(state, n).detach().cpu().numpy() for n in FIELD_NAMES}


# ---------------------------------------------------------------------------
# Checkpoint / resume: the JAX package's v2 by-name npz schema
# ---------------------------------------------------------------------------

_CKPT_VERSION = 2


def save_checkpoint(path: str, state: ParticleState, step: int = 0,
                    cfg: SimConfig | None = None) -> None:
    """Write every state field under `field_<name>`, the global step and,
    when given, a JSON snapshot of the config."""
    arrays = {f"field_{k}": v for k, v in state_to_numpy(state).items()}
    arrays["__step__"] = np.asarray(step, dtype=np.int64)
    arrays["__version__"] = np.asarray(_CKPT_VERSION, dtype=np.int64)
    if cfg is not None:
        arrays["__config__"] = np.frombuffer(
            json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    # through a file handle: np.savez_compressed(str) appends '.npz' to
    # suffix-less paths, which would break a same-string save/load
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_checkpoint(path: str, with_config: bool = False, device="cuda"):
    """Load a by-name checkpoint onto `device` -> (state, step) or (state,
    step, cfg|None). Missing or unknown fields raise."""
    device = resolve_device(device)
    with np.load(path) as data:
        if "__step__" not in data:
            raise ValueError(f"{path}: not a sph_sm_monodomain checkpoint "
                             "(missing __step__ field)")
        if not any(k.startswith("field_") for k in data.files):
            raise ValueError(f"{path}: legacy positional checkpoint "
                             "(leaf_<i>) — not supported by the port")
        step = int(data["__step__"])
        fields = {k[6:]: data[k] for k in data.files if k.startswith("field_")}
        raw_cfg = (json.loads(bytes(data["__config__"]).decode())
                   if "__config__" in data.files else None)
    try:
        state = state_from_numpy(fields, device=device)
    except ValueError as e:
        raise ValueError(f"{path}: {e} (written by an incompatible "
                         "version)") from None
    if not with_config:
        return state, step
    return state, step, (None if raw_cfg is None
                         else config_from_dict(raw_cfg))
