"""sph_sm_monodomain_tpu_torch — the PyTorch + CUDA port of
sph_sm_monodomain_tpu, for NVIDIA Hopper GPUs.

Coupled SPH + shape-matching + monodomain skeletal-muscle simulation: a
dataclass-of-tensors particle state, the v4 fused coupled step (two
hand-written CUDA sweep kernels, csrc/fused_sweeps.cu, with plain PyTorch
versions that run on the CPU), its differentiable form `step_fused_diff`
(two hand-written backward sweep kernels, csrc/fused_adjoint.cu), the
unfused reference step `step`, the chunked run loops, and the variant
modes of `variants` (SPH-only, SM-only, and the frozen-cloud monodomain
mode on a hand-written Laplacian kernel, forward and backward), the v3 /
v5 generations of the fused step and the v1 / v2 ablation baselines
(`ablation/`), each on its own hand-written sweep kernels, and the roofline
tool (`tools/roofline.py`, whose FMA-chain probe measures the card's fp32
peak). Shape matching runs over one global cluster or one cluster a muscle
(`build_scene(..., replicate=k)`); `examples/` holds the contraction demo
(frames through the numpy renderer, `utils/render.py`) and the stimulus,
material, flagship and fhn fits. Entry points build on the card unless given device="cpu". The JAX package is the reference this port is tested
against; this package imports neither jax nor sph_sm_monodomain_tpu.
"""

from .config import (SimConfig, DEFAULT_CONFIG, PARAM_FIELDS, resolve_params,
                     config_from_dict)
from .state import (ParticleState, init_fluid, save_checkpoint,
                    load_checkpoint, state_from_numpy, state_to_numpy)
from .models.monodomain import (step, step_fused, step_fused_diff, simulate,
                                run_protocol, StepAux)
from .utils.io import build_scene, read_cloud_csv, Scene
from .ops import electrophysiology as stim
from .models import variants

__all__ = [
    "SimConfig", "DEFAULT_CONFIG", "PARAM_FIELDS", "resolve_params",
    "config_from_dict", "ParticleState", "init_fluid", "save_checkpoint",
    "load_checkpoint", "state_from_numpy", "state_to_numpy", "step",
    "step_fused", "step_fused_diff", "simulate", "StepAux", "run_protocol",
    "build_scene", "read_cloud_csv", "Scene", "stim", "variants",
]

__version__ = "0.1.0"
