"""The yardstick against the package: the frozen pair counts against the
package's roofline tool, and the plain reference against the package's CPU
path for one step on a small scene."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import flops
from benchmark.common import BENCH
from benchmark.drivers import PROG
from benchmark.drivers.protocol import CARRY
from benchmark.reference import physics as ref

PHYS = json.loads((BENCH / "configs" / "biceps_full.json").read_text())[
    "physics"]


def _pairs(scene: str, device: str):
    from sph_sm_monodomain_tpu_torch.tools.roofline import scene_pair_counts
    from sph_sm_monodomain_tpu_torch.utils.io import build_scene
    sc = build_scene(scene, device=device)
    cfg, n = sc.cfg, sc.num_particles
    return (scene_pair_counts(sc),
            flops.pair_counts(sc.state.pos[:n], cfg.cell_size, cfg.kernel_h,
                              cfg.grid_size))


@pytest.mark.parametrize("scene", ["susane", "biceps_1"])
def test_pair_counts_match_the_roofline_tool(scene):
    want, got = _pairs(scene, "cpu")
    assert got == want


@pytest.mark.cuda
def test_pair_counts_match_on_biceps_full(card):
    want, got = _pairs("biceps_full", "cuda")
    assert got == want


def _scene(vm_seed: int):
    from sph_sm_monodomain_tpu_torch.utils.io import build_scene
    sc = build_scene("biceps_1", device="cpu")
    n = sc.num_particles
    vm = torch.randn(n, generator=torch.Generator().manual_seed(vm_seed)) * 5
    full = sc.state.vm.clone()
    full[:n] = vm
    return sc._replace(state=sc.state.replace(vm=full)), vm


def test_reference_step_matches_the_package():
    """One coupled step from a state two steps into the protocol: the
    package's CPU path (float32) against the float64 reference, within
    float32 rounding of each field."""
    from sph_sm_monodomain_tpu_torch.models.monodomain import run_protocol
    sc, vm = _scene(3)
    n = sc.num_particles
    P = ref.Physics(PHYS)
    r0 = ref.initial_state(sc.state.pos[:n], vm, P, 1)
    for k, f in PROG.items():
        want = r0[k] if k == "fixed" else r0[k].float()
        assert torch.equal(getattr(sc.state, f)[:n], want), k
    s2 = run_protocol(sc, num_steps=2, stim_off_step=-1)[0]
    got = run_protocol(sc._replace(state=s2), num_steps=1,
                       stim_off_step=-1)[0]
    want = ref.step(dict(r0, **{k: getattr(s2, PROG[k])[:n].double()
                                for k in CARRY}), P)
    for f, tol in (("goal", 1e-5), ("vm", 1e-4), ("pos", 1e-5)):
        assert float((getattr(got, PROG[f])[:n] - want[f]).abs().max()) \
            < tol, f
    rel = (got.dens[:n] - want["dens"]).abs() / want["dens"]
    assert float(rel.max()) < 1e-5


def test_reference_wave_matches_the_package():
    from sph_sm_monodomain_tpu_torch.models import variants
    sc, vm = _scene(4)
    n = sc.num_particles
    P = ref.Physics(PHYS)
    tables = variants.monodomain_prepare_fused(sc.state, sc.cfg,
                                               sc.sub_block)
    got = variants.simulate_monodomain_only_fused(sc.state, tables, sc.cfg,
                                                  5, sub_q=sc.sub_block)
    want = ref.run_wave(ref.initial_state(sc.state.pos[:n], vm, P, 1), P, 5)
    assert float((got.vm[:n] - want["vm"]).abs().max()) < 1e-4
    assert float(((tables.dens[:n] - want["dens"]).abs()
                  / want["dens"]).max()) < 1e-5


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10,
                      -3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0])
    assert torch.equal(ref.tf32(x), want)
