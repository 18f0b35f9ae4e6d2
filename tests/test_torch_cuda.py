"""The port's CUDA sweep kernels on the card, against their plain PyTorch
versions (marker `cuda`; skipped where torch sees no GPU).

This file imports neither jax nor the JAX package, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: per output column, |kernel - plain| <= 1e-5 * max(1, max|plain
column|) — both fp32, summed in another order, the kernel with rsqrtf.
"""

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA sweep kernels have no "
                    "CPU mode; their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _blob(device, n=900, seed=0, **cfg_overrides):
    rng = np.random.default_rng(seed)
    cfg = T.SimConfig(**cfg_overrides)
    pts = np.clip(rng.normal(size=(n, 3)).astype(np.float32) * 0.06 + 0.6,
                  0.05, 1.2)
    st = T.init_fluid(pts, cfg, device=device)
    st = T.stim.set_stim(st, (0.6, 0.6, 0.6), 0.3, cfg.stim_strength, cfg)
    cap = st.capacity
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(device)
    return cfg, st.replace(corrected_vel=r(cap, 3) * 0.1, vm=r(cap) * 10.0,
                           dens=cfg.stand_density + r(cap) * 20.0)


def _check(got, want, what):
    bound = 1e-5 * torch.clamp(want.abs().amax(dim=0), min=1.0)
    err = (got - want).abs().amax(dim=0)
    assert torch.isfinite(got).all(), what
    assert bool((err <= bound).all()), (what, err.tolist())


@pytest.mark.parametrize("case", ["default", "no_ep", "full_mask", "dynp"])
def test_kernels_match_plain(device, case):
    over = {"cell_size": 0.03} if case == "full_mask" else {}
    cfg, st = _blob(device, **over)
    with_ep = case != "no_ep"
    dynp = (fst.build_dynp(T.resolve_params(cfg, {"k_stiffness": 0.8,
                                                  "mu_viscosity": 40.0}),
                           device) if case == "dynp" else None)
    order, inv, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                     128)
    fs, fa = fst.build_qm_feats(st, cx, cyz, order)
    n_a, n_b = fst.sweep_a3.launches, fst.sweep_b3.launches
    want_a = fst.sweep_a3_plain(fs, fa, cfg, with_ep, dynp)
    got_a = fst.sweep_a3(fs, fa, lo, hi, cfg, with_ep, 128, dynp)
    _check(got_a, want_a, "OUT_A")
    vol = torch.where(want_a[:, 8] > 0, want_a[:, 10] / want_a[:, 8],
                      torch.zeros_like(want_a[:, 8]))
    fb = fst.feats_from_out_a(want_a, vol)
    want_b = fst.sweep_b3_plain(want_a, fb, cfg, with_ep, dynp)
    got_b = fst.sweep_b3(want_a, fb, lo, hi, cfg, with_ep, 128, dynp)
    torch.cuda.synchronize()
    _check(got_b, want_b, "OUT_B")
    assert (fst.sweep_a3.launches, fst.sweep_b3.launches) == (n_a + 1,
                                                              n_b + 1)


def test_wrappers_reject_bad_inputs(device):
    cfg, st = _blob(device, n=200)
    order, inv, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                     128)
    fs, fa = fst.build_qm_feats(st, cx, cyz, order)
    with pytest.raises(ValueError):
        fst.sweep_a3(fs, fa, lo.to(torch.int64), hi, cfg)
    with pytest.raises(ValueError):
        fst.sweep_a3(fs, fa.t().contiguous().t(), lo, hi, cfg)
    with pytest.raises(ValueError):
        fst.sweep_a3(fs, fa.cpu(), lo, hi, cfg)


def test_step_on_card_matches_cpu(device):
    cfg, st = _blob(device, n=600, seed=3)
    got, _ = T.step_fused(st, cfg)
    want, _ = T.step_fused(st.to("cpu"), cfg)
    g, w = T.state_to_numpy(got), T.state_to_numpy(want)
    act = w["active"]
    for name, atol in (("pos", 5e-5), ("vel", 5e-3), ("vm", 5e-3),
                       ("iion", 1e-5), ("w", 1e-6)):
        np.testing.assert_allclose(g[name][act], w[name][act], atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(g["dens"][act], w["dens"][act], rtol=1e-5)
