"""sph_sm_monodomain_tpu_torch — the PyTorch + CUDA port of
sph_sm_monodomain_tpu, for NVIDIA Hopper GPUs.

Coupled SPH + shape-matching + monodomain skeletal-muscle simulation: a
dataclass-of-tensors particle state, the v4 fused coupled step (two
hand-written CUDA sweep kernels, csrc/fused_sweeps.cu, with plain PyTorch
versions that run on the CPU), and the chunked run loops. The JAX package
is the reference this port is tested against; this package imports neither
jax nor sph_sm_monodomain_tpu.
"""

from .config import (SimConfig, DEFAULT_CONFIG, PARAM_FIELDS, resolve_params,
                     config_from_dict)
from .state import (ParticleState, init_fluid, save_checkpoint,
                    load_checkpoint, state_from_numpy, state_to_numpy)
from .models.monodomain import step_fused, simulate, run_protocol, StepAux
from .utils.io import build_scene, read_cloud_csv, Scene
from .ops import electrophysiology as stim

__all__ = [
    "SimConfig", "DEFAULT_CONFIG", "PARAM_FIELDS", "resolve_params",
    "config_from_dict", "ParticleState", "init_fluid", "save_checkpoint",
    "load_checkpoint", "state_from_numpy", "state_to_numpy", "step_fused",
    "simulate", "StepAux", "run_protocol", "build_scene", "read_cloud_csv",
    "Scene", "stim",
]

__version__ = "0.1.0"
