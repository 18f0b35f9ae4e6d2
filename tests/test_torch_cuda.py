"""The port's CUDA sweep kernels (forward in the v4, v3 and v5 forms,
backward, the Laplacian-only sweep, and the v1 / v2 raw-sum sweeps), the
roofline tool's FMA-chain probe, its fused steps, its differentiable step
and the monodomain mode's gradient on the card, against their plain
PyTorch versions and the CPU path (marker `cuda`; skipped where torch sees
no GPU).

This file imports neither jax nor the JAX package, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: per output column, |kernel - plain| <= 1e-5 * max(1, max|plain
column|) — both fp32, summed in another order, the kernel with rsqrtf. The
FMA-chain probe: roofline.FMA_ULP_TOL (2) float32 ulps of the chain sum,
since both round each chain step once, as fmaf does.
Gradients, card against CPU: rtol 1e-3 (the JAX suite's 3-step bound);
through the Laplacian kernel, value rtol 1e-5 and gradient atol
1e-4 * max(1, max|g|) (tests/test_differentiable.py:91-96).
"""

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ablation import legacy_sweeps as tls
from sph_sm_monodomain_tpu_torch.models import variants
from sph_sm_monodomain_tpu_torch.ops import fused_adjoint as fad
from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
from sph_sm_monodomain_tpu_torch.ops.shape_matching import sm_invariants
from sph_sm_monodomain_tpu_torch.ops.sweeps import (auto_sweep5_params,
                                                    sweep_bookkeeping2,
                                                    sweep_bookkeeping3,
                                                    sweep_bookkeeping5)
from sph_sm_monodomain_tpu_torch.tools import roofline
from sph_sm_monodomain_tpu_torch.utils.io import ASSETS_DIR

from parity_clouds import (BICEPS_CSV, WIDE_WORLD, blob_fields, blob_points,
                           sparse_points, wide_points)

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


def _parity_state(device, case):
    """(cfg, state) of the parity states of tests/torch_parity.named_state,
    built with the port from the same numpy draws (tests/parity_clouds.py):
    "padded" (200 particles in 256 rows, random fields), "slice" (the
    462-particle biceps slice, stim mesh on), "wide_world" (a stretched
    world: the hash axes permute) or "sparse" (two far clusters, whose
    sub-blocks' windows overlap)."""
    cfg = T.SimConfig()
    rng = np.random.default_rng(7)
    if case == "padded":
        rng = np.random.default_rng(0)
        st = T.init_fluid(blob_points(rng, 200), cfg, device=device)
        st = T.stim.set_stim(st, (0.6, 0.6, 0.6), 0.3, cfg.stim_strength,
                             cfg)
        return cfg, st.replace(**{
            k: torch.from_numpy(v).to(device)
            for k, v in blob_fields(rng, st.capacity,
                                    cfg.stand_density).items()})
    if case == "slice":
        pts = T.read_cloud_csv(ASSETS_DIR / BICEPS_CSV)[::40]
        st = T.init_fluid(pts, cfg, device=device)
        return cfg, T.stim.turn_on_stim_mesh(st, pts, cfg)
    if case == "wide_world":
        cfg = cfg.replace(world_size=WIDE_WORLD)
        pts = wide_points(rng)
    else:
        pts = sparse_points(rng)
    st = T.init_fluid(pts.astype(np.float32), cfg, device=device)
    return cfg, T.stim.set_stim(st, tuple(pts[0]), 0.5, cfg.stim_strength,
                                cfg)


def _k1_variants(cfg, device):
    """(label, config, sweep_a3 keywords) of the K1 checks: the defaults,
    with_ep off, a dynp vector, a grid finer than h (the plain version's
    full mask), and each quirk off in turn (all three are on by
    default)."""
    dynp = fst.build_dynp(T.resolve_params(cfg, {"k_stiffness": 0.8,
                                                 "mu_viscosity": 40.0}),
                          device)
    out = [("default", cfg, {}), ("no_ep", cfg, {"with_ep": False}),
           ("dynp", cfg, {"dynp": dynp}),
           ("full_mask", cfg.replace(cell_size=0.03), {})]
    for q in ("quirk_double_self_density", "quirk_pressure_stim_gate",
              "quirk_iion_accumulate"):
        out.append((f"no_{q}", cfg.replace(**{q: False}), {}))
    return out


@pytest.mark.parametrize("case", ["padded", "slice", "wide_world", "sparse"])
def test_k1_matches_plain(device, case):
    """The warp-trimmed sweep A (K1) against its plain version on the
    parity states at sub_q 32, 64 and 128 (where the capacity allows),
    with the variants of _k1_variants: the plain version's cyz-only mask
    (cell_size >= h) and its full mask (cell_size < h) both give the
    kernel's sums; one launch counted per call, two launches bitwise
    equal."""
    cfg0, st = _parity_state(device, case)
    masks = set()
    for sub_q in (32, 64, 128):
        if st.capacity % sub_q:
            continue
        for label, cfg, kw in _k1_variants(cfg0, device):
            masks.add(fst._mask_a_full(cfg))
            order, _, lo, hi, cx, cyz = sweep_bookkeeping3(
                st.pos, st.active, cfg, sub_q)
            fs, fa = fst.build_qm_feats(st, cx, cyz, order)
            n0 = fst.sweep_a3.launches
            got = fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sub_q, **kw)
            again = fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sub_q, **kw)
            torch.cuda.synchronize()
            assert fst.sweep_a3.launches == n0 + 2
            _check(got, fst.sweep_a3_plain(fs, fa, cfg, kw.get("with_ep",
                                                                True),
                                           kw.get("dynp")),
                   f"{case} sub_q {sub_q} K1 {label}")
            assert torch.equal(got, again), (case, sub_q, label)
    assert masks == {False, True}


def _v5_slabs(st, cfg, sub_q, kb, w_chunk=128):
    """(QM_A, sweep-A slabs, trips, src, overflow) of a state's v5 step 0."""
    order, _, src, trips, over, cf, cm, cs = sweep_bookkeeping5(
        st.pos, st.active, cfg, sub_q, kb, w_chunk)
    fs = fst.build_qm_feats5(st, cf, cm, cs, order)
    return fs, fst.pack_feats_a5(fs, src, kb), trips, src, int(over)


def _check_k7(fs, pa, trips, src, kb, cfg, what, **kw):
    """K7 A and B against their plain versions (B on the plain A's
    output), with and without EP, each launched twice: bitwise equal."""
    for with_ep in (True, False):
        n0 = (fst.sweep_a5.launches, fst.sweep_b5.launches)
        got = fst.sweep_a5(fs, pa, trips, cfg, with_ep, **kw)
        again = fst.sweep_a5(fs, pa, trips, cfg, with_ep, **kw)
        want_a = fst.sweep_a5_plain(fs, pa, cfg, with_ep)
        torch.cuda.synchronize()
        _check(got, want_a, f"{what} K7 A ep={with_ep}")
        assert torch.equal(got, again), (what, "A", with_ep)
        pb = fst.pack_feats_b5(want_a, fst.vol_now(want_a), src, kb)
        got = fst.sweep_b5(want_a, pb, trips, cfg, with_ep, **kw)
        again = fst.sweep_b5(want_a, pb, trips, cfg, with_ep, **kw)
        torch.cuda.synchronize()
        _check(got, fst.sweep_b5_plain(want_a, pb, cfg, with_ep),
               f"{what} K7 B ep={with_ep}")
        assert torch.equal(got, again), (what, "B", with_ep)
        assert (fst.sweep_a5.launches, fst.sweep_b5.launches) == (
            n0[0] + 2, n0[1] + 2)


@pytest.mark.parametrize("case", ["padded", "slice", "wide_world", "sparse",
                                  "biceps_full"])
def test_k7_matches_plain(device, case):
    """The warp-trimmed slab sweeps (K7 A and B) against their plain
    versions at sub_q 16 (a warp's rows span two slabs), 32 and 64, over
    the trips and over the whole slab (static_trips, v5s), with and
    without EP, each launch repeated bitwise, and sweep A over the trips
    bitwise equal to sweep A over the whole slab; the slab capacity is the
    tuner's for that sub_q."""
    if case == "biceps_full":
        sc = T.build_scene("biceps_full", device=device)
        cfg, st = sc.cfg, sc.state
    else:
        cfg, st = _parity_state(device, case)
    pts = st.pos[st.active].cpu().numpy()
    for sub_q in (16, 32, 64):
        if st.capacity % sub_q:
            continue
        kb = auto_sweep5_params(pts, cfg, sub_qs=(sub_q,))[1]
        fs, pa, trips, src, over = _v5_slabs(st, cfg, sub_q, kb)
        assert over == 0
        for static in (False, True):
            _check_k7(fs, pa, trips, src, kb, cfg,
                      f"{case} sub_q {sub_q} static {static}", sub_q=sub_q,
                      w_chunk=128, static_trips=static)
        # the whole slab's padding slots change no bit
        kw = dict(sub_q=sub_q, w_chunk=128)
        assert torch.equal(fst.sweep_a5(fs, pa, trips, cfg, **kw),
                           fst.sweep_a5(fs, pa, trips, cfg, **kw,
                                        static_trips=True)), (case, sub_q)


@pytest.mark.parametrize("sub_q", [16, 32, 64])
def test_k7_after_forced_regrow(device, sub_q):
    """K7 on the padded blob at the slab capacity run_protocol's regrow
    reaches from 128 slots (1.5x, rounded up to 128, until nothing
    overflows), the step-0 overflow at 128 being non-zero."""
    cfg, st = _parity_state(device, "padded")
    kb = 128
    assert _v5_slabs(st, cfg, sub_q, kb)[4] > 0
    while _v5_slabs(st, cfg, sub_q, kb)[4]:
        kb = ((int(kb * 1.5) + 127) // 128) * 128
    fs, pa, trips, src, _ = _v5_slabs(st, cfg, sub_q, kb)
    _check_k7(fs, pa, trips, src, kb, cfg, f"regrown kb {kb}", sub_q=sub_q,
              w_chunk=128)


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
    fb = fst.feats_b(want_a)
    want_b = fst.sweep_b3_plain(want_a, fb, cfg, with_ep, dynp)
    got_b = fst.sweep_b3(want_a, fb, lo, hi, cfg, with_ep, 128, dynp)
    torch.cuda.synchronize()
    _check(got_b, want_b, "OUT_B")
    assert (fst.sweep_a3.launches, fst.sweep_b3.launches) == (n_a + 1,
                                                              n_b + 1)


@pytest.mark.parametrize("case", ["hash9", "hash9_dynp", "v5_sub_q16",
                                  "v5_sub_q32", "v5s", "v5_w512"])
def test_v3_v5_kernels_match_plain(device, case):
    """The v3 (hash9) and v5 (slab) sweep kernels against their plain
    versions on a blob with padding rows, each launched once."""
    cfg, st = _blob(device)
    if case.startswith("hash9"):
        dynp = (fst.build_dynp(T.resolve_params(cfg, {"mu_viscosity": 40.0}),
                               device) if case == "hash9_dynp" else None)
        order, inv, lo, hi, chash = sweep_bookkeeping2(st.pos, st.active, cfg,
                                                       64)
        fs, fa = fst.build_qm_feats(st, chash, torch.zeros_like(chash), order)
        kernels = (fst.sweep_a3_hash9, fst.sweep_b3_hash9)
        run_a = lambda q: fst.sweep_a3_hash9(q, fa, lo, hi, cfg,  # noqa: E731
                                             sub_q=64, dynp=dynp)
        want_a = fst.sweep_a3_plain(fs, fa, cfg, dynp=dynp, stencil="hash9")
        fb = fst.feats_b(want_a)
        run_b = lambda q: fst.sweep_b3_hash9(q, fb, lo, hi, cfg,  # noqa: E731
                                             sub_q=64, dynp=dynp)
        plain_b = lambda q: fst.sweep_b3_plain(  # noqa: E731
            q, fb, cfg, dynp=dynp, stencil="hash9")
    else:
        sub_q = 16 if case == "v5_sub_q16" else 32
        w_chunk = 512 if case == "v5_w512" else 128
        kb = auto_sweep5_params(st.pos[st.active].cpu().numpy(), cfg,
                                sub_qs=(sub_q,))[1]
        kb = -(-kb // w_chunk) * w_chunk
        order, inv, src, trips, over, cf, cm, cs = sweep_bookkeeping5(
            st.pos, st.active, cfg, sub_q, kb, w_chunk)
        assert int(over) == 0
        fs = fst.build_qm_feats5(st, cf, cm, cs, order)
        kw = dict(sub_q=sub_q, w_chunk=w_chunk, static_trips=case == "v5s")
        kernels = (fst.sweep_a5, fst.sweep_b5)
        pa = fst.pack_feats_a5(fs, src, kb)
        run_a = lambda q: fst.sweep_a5(q, pa, trips, cfg, **kw)  # noqa: E731
        want_a = fst.sweep_a5_plain(fs, pa, cfg)
        pb = fst.pack_feats_b5(want_a, fst.vol_now(want_a), src, kb)
        run_b = lambda q: fst.sweep_b5(q, pb, trips, cfg, **kw)  # noqa: E731
        plain_b = lambda q: fst.sweep_b5_plain(q, pb, cfg)  # noqa: E731
    before = [k.launches for k in kernels]
    _check(run_a(fs), want_a, f"{case} OUT_A")
    got_b = run_b(want_a)
    torch.cuda.synchronize()
    _check(got_b, plain_b(want_a), f"{case} OUT_B")
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1]


@pytest.mark.parametrize("impl", ["v3", "v5"])
def test_v3_v5_step_on_card_matches_cpu(device, impl):
    """Two v3 / v5 steps on the card (kernels) against the CPU (plain
    versions), at the JAX suite's fused-step tolerances."""
    cfg, st = _blob(device, n=600, seed=3)
    kw = dict(impl=impl, pack_cap=1024 if impl == "v5" else 0)
    got, want = st, st.to("cpu")
    for _ in range(2):
        got, aux = T.step_fused(got, cfg, **kw)
        want, _ = T.step_fused(want, cfg, **kw)
        assert int(aux.overflow) == 0
    g, w = T.state_to_numpy(got), T.state_to_numpy(want)
    act = w["active"]
    for name, atol in (("pos", 5e-5), ("vel", 5e-3), ("vm", 5e-3),
                       ("iion", 1e-5), ("w", 1e-6)):
        np.testing.assert_allclose(g[name][act], w[name][act], atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(g["dens"][act], w["dens"][act], rtol=1e-5)


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


def test_checkpointed_grad_on_card_matches_cpu(device):
    """A 2-step checkpointed rollout's grad w.r.t. log(K, mu): the card
    (kernels) against the CPU (plain versions), and the launch counts of
    one value-and-grad: the forward kernels 2S times (checkpointing
    recomputes each step), the backward kernels S times."""
    from torch.utils.checkpoint import checkpoint
    cfg, st = _blob(device, n=600, seed=3)
    # off the rest shape and moving, so that d/d mu is not rounding noise
    rng = np.random.default_rng(4)
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(device)
    act = st.active[:, None]
    st = st.replace(pos=st.pos + r(st.capacity, 3) * 0.003 * act,
                    vel=r(st.capacity, 3) * 0.05)
    steps = 2

    def value_and_grad(s0):
        inv = sm_invariants(s0, cfg)
        th = torch.log(torch.tensor([0.5, 100.0], device=s0.device)) \
            .requires_grad_()
        p = {"k_stiffness": torch.exp(th[0]), "mu_viscosity": torch.exp(th[1])}
        s = s0
        for _ in range(steps):
            s = checkpoint(lambda x: T.step_fused_diff(x, cfg, sm_inv=inv,
                                                       params=p),
                           s, use_reentrant=False)
        d = torch.where(s.active[:, None], s.pos - s.orig_pos,
                        torch.zeros_like(s.pos))
        val = (d * d).sum() * 1e6
        (g,) = torch.autograd.grad(val, th)
        return float(val.detach()), g.cpu().numpy()

    kernels = (fst.sweep_a3, fst.sweep_b3, fad.sweep_bwd_a, fad.sweep_bwd_b)
    before = [k.launches for k in kernels]
    vc, gc = value_and_grad(st)
    assert [k.launches - b for k, b in zip(kernels, before)] \
        == [2 * steps, 2 * steps, steps, steps]
    vp, gp = value_and_grad(st.to("cpu"))
    np.testing.assert_allclose(vc, vp, rtol=1e-3)
    np.testing.assert_allclose(gc, gp, rtol=1e-3)


@pytest.mark.parametrize("form", ["forward", "backward"])
def test_lap_kernel_matches_plain(device, form):
    """The Laplacian-only sweep on the monodomain tables of a blob with
    padding rows: the forward form and the backward form (zero query vm,
    unit candidate volumes, a random cotangent as candidate vm)."""
    cfg, st = _blob(device)
    tab = variants.monodomain_prepare_fused(st, cfg)
    n = st.capacity
    g = torch.from_numpy(np.random.default_rng(2).normal(size=n).astype(
        np.float32) * 10.0).to(device)
    if form == "forward":
        vm_q, vol, vm_row = g, tab.vol_s, g
    else:
        vm_q, vol, vm_row = torch.zeros_like(g), torch.ones_like(g), g
    qm, feats = variants._lap_inputs(vm_q, vol, vm_row, tab.pos_s, tab.cx_s,
                                     tab.cyz_s)
    n0 = fst.sweep_lap3.launches
    got = fst.sweep_lap3(qm, feats, tab.blk_lo, tab.blk_hi, cfg)
    torch.cuda.synchronize()
    _check(got, fst.sweep_lap3_plain(qm, feats, cfg), form)
    assert fst.sweep_lap3.launches == n0 + 1
    with pytest.raises(ValueError):
        fst.sweep_lap3(qm, feats.cpu(), tab.blk_lo, tab.blk_hi, cfg)


def _redesign_state(device, case):
    """(cfg, state, the sub_q values the wrappers accept at its capacity):
    "blob" (900 particles in 1024 rows: dead rows at the sentinel, a last
    sub-block with empty windows), "sparse" (two tight clusters far apart
    along the fast axis, whose sub-blocks' windows overlap), "isolated" (40
    scattered particles: windows shorter than one warp's slice, many
    empty) or "biceps_full" (its step-0 state)."""
    if case == "biceps_full":
        sc = T.build_scene("biceps_full", device=device)
        cfg, st = sc.cfg, sc.state
    elif case == "blob":
        cfg, st = _blob(device)
    else:
        rng = np.random.default_rng(7)
        cfg = T.SimConfig()
        if case == "sparse":
            pts = np.concatenate([rng.random((48, 3)) * 0.08 + 0.05,
                                  rng.random((48, 3)) * 0.08 + 1.3])
        else:
            pts = rng.random((40, 3)) * 1.4 + 0.05
        st = T.init_fluid(pts.astype(np.float32), cfg, device=device)
        st = st.replace(vm=torch.from_numpy(rng.normal(
            size=st.capacity).astype(np.float32) * 10.0).to(device))
    n = st.capacity
    return cfg, st, [q for q in range(32, 1025, 32) if n % q == 0]


@pytest.mark.parametrize("case", ["blob", "sparse", "isolated",
                                  "biceps_full"])
def test_redesigned_kernels_match_plain(device, case):
    """The warp-trimmed sweep B (K2: with and without EP, and with dynp)
    and the Laplacian sweep (K3: forward and backward forms) against their
    plain versions at every sub_q the wrappers accept, and two launches of
    each bitwise equal."""
    cfg, st, sub_qs = _redesign_state(device, case)
    dynp = fst.build_dynp(T.resolve_params(cfg, {"k_stiffness": 0.8,
                                                 "mu_viscosity": 40.0}),
                          device)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=st.capacity).astype(np.float32)).to(device)
    for sub_q in sub_qs:
        order, inv, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active,
                                                         cfg, sub_q)
        fs, fa = fst.build_qm_feats(st, cx, cyz, order)
        out_a = fst.sweep_a3_plain(fs, fa, cfg)
        fb = fst.feats_b(out_a)
        for kw in ({}, {"with_ep": False}, {"dynp": dynp}):
            got = fst.sweep_b3(out_a, fb, lo, hi, cfg, sub_q=sub_q, **kw)
            again = fst.sweep_b3(out_a, fb, lo, hi, cfg, sub_q=sub_q, **kw)
            torch.cuda.synchronize()
            _check(got, fst.sweep_b3_plain(out_a, fb, cfg, **kw),
                   f"{case} sub_q {sub_q} K2 {kw}")
            assert torch.equal(got, again), (case, sub_q, kw)
        tab = variants.monodomain_prepare_fused(st, cfg, sub_q=sub_q)
        vm = st.vm[tab.order]
        for form, (vm_q, vol, vm_row) in (
                ("forward", (vm, tab.vol_s, vm)),
                ("backward", (torch.zeros_like(g), torch.ones_like(g), g))):
            qm, feats = variants._lap_inputs(vm_q, vol, vm_row, tab.pos_s,
                                             tab.cx_s, tab.cyz_s)
            got = fst.sweep_lap3(qm, feats, tab.blk_lo, tab.blk_hi, cfg,
                                 sub_q)
            again = fst.sweep_lap3(qm, feats, tab.blk_lo, tab.blk_hi, cfg,
                                   sub_q)
            torch.cuda.synchronize()
            _check(got, fst.sweep_lap3_plain(qm, feats, cfg),
                   f"{case} sub_q {sub_q} K3 {form}")
            assert torch.equal(got, again), (case, sub_q, form)


@pytest.mark.parametrize("case", ["blob", "sparse", "isolated",
                                  "biceps_full"])
def test_backward_kernels_match_plain(device, case):
    """The warp-trimmed backward sweeps (K4; K5 with and without dynp) on
    seeded random cotangents against their plain versions at every sub_q
    the wrappers accept, two launches of each bitwise equal, one launch
    counted per call."""
    cfg, st, sub_qs = _redesign_state(device, case)
    dynp = fst.build_dynp(T.resolve_params(cfg, {"mu_viscosity": 40.0}),
                          device)
    rng = np.random.default_rng(1)
    n = st.capacity
    cot = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    g_d, g_x, g_a, g_l = cot(n), cot(n, 3), cot(n, 3), cot(n)
    for sub_q in sub_qs:
        order, inv, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active,
                                                         cfg, sub_q)
        fs, fa = fst.build_qm_feats(st, cx, cyz, order)
        out_a = fst.sweep_a3_plain(fs, fa, cfg)
        qa = fad.bwd_a_query(fs, g_d, g_x)
        qb = fad.bwd_b_query(out_a, g_a, g_l)
        fqa, fqb = qa.T.contiguous(), qb.T.contiguous()
        n_a = fad.sweep_bwd_a.launches
        got = fad.sweep_bwd_a(qa, fqa, lo, hi, cfg, sub_q)
        again = fad.sweep_bwd_a(qa, fqa, lo, hi, cfg, sub_q)
        torch.cuda.synchronize()
        _check(got, fad.sweep_bwd_a_plain(qa, fqa, cfg),
               f"{case} sub_q {sub_q} K4")
        assert torch.equal(got, again), (case, sub_q)
        assert fad.sweep_bwd_a.launches == n_a + 2
        for d in (None, dynp):
            n_b = fad.sweep_bwd_b.launches
            got = fad.sweep_bwd_b(qb, fqb, lo, hi, cfg, sub_q, dynp=d)
            again = fad.sweep_bwd_b(qb, fqb, lo, hi, cfg, sub_q, dynp=d)
            torch.cuda.synchronize()
            _check(got, fad.sweep_bwd_b_plain(qb, fqb, cfg, d),
                   f"{case} sub_q {sub_q} K5 dynp {d is not None}")
            assert torch.equal(got, again), (case, sub_q, d is not None)
            assert fad.sweep_bwd_b.launches == n_b + 2


def _raw_inputs(st, order, chash, cfg):
    """The v2 raw-sum sweeps' sorted sweep-A fields (pos, cvel, vol, mass,
    hash) of a state, the volume from the state's densities."""
    pos, cvel, mass, dens = (st.pos[order], st.corrected_vel[order],
                             st.mass[order], st.dens[order])
    return (pos, cvel, fst._safe_div(mass, dens, dens > 0.0), mass,
            chash[order])


def _raw_b_inputs(a_in, dens, xsph, vm, cfg):
    """The v2 sweep-B fields derived from sweep A's fields and sums, as
    ablation/legacy_steps.py derives them."""
    pos, cvel, _, mass, hash_s = a_in
    vol = fst._safe_div(mass, dens, dens > 0.0)
    pres = cfg.k_stiffness * (dens - cfg.stand_density)
    return (pos, cvel + xsph * cfg.velocity_mixing, vol, pres, vm, hash_s)


def _hash9_runs(st, cfg, sub_q, dynp):
    """{label: (launch, plain(query rows), query matrix)} of the v3 hash9
    sweeps K6 A / B (default, no_ep, dynp) and the v2 raw-sum sweeps K9 A /
    B at `sub_q` on a state; sweep B's inputs come from the sweep-A kernels
    (the plain versions would take minutes on 296k rows), and each launch
    counts one launch."""
    order, _, lo, hi, chash = sweep_bookkeeping2(st.pos, st.active, cfg,
                                                 sub_q)
    fs, fa = fst.build_qm_feats(st, chash, torch.zeros_like(chash), order)
    runs = {}
    for tag, kw in (("", {}), (" no_ep", {"with_ep": False}),
                    (" dynp", {"dynp": dynp})):
        ep, d = kw.get("with_ep", True), kw.get("dynp")
        out_a = fst.sweep_a3_hash9(fs, fa, lo, hi, cfg, sub_q=sub_q, **kw)
        fb = fst.feats_b(out_a)
        runs[f"K6 A{tag}"] = (
            lambda kw=kw: fst.sweep_a3_hash9(fs, fa, lo, hi, cfg,
                                             sub_q=sub_q, **kw),
            lambda q, ep=ep, d=d: fst.sweep_a3_plain(q, fa, cfg, ep, d,
                                                     "hash9"), fs)
        runs[f"K6 B{tag}"] = (
            lambda kw=kw, o=out_a, f=fb: fst.sweep_b3_hash9(
                o, f, lo, hi, cfg, sub_q=sub_q, **kw),
            lambda q, ep=ep, d=d, f=fb: fst.sweep_b3_plain(q, f, cfg, ep, d,
                                                           "hash9"), out_a)
    a_in = _raw_inputs(st, order, chash, cfg)
    qa, feats_a = tls._inputs_a(*a_in)
    dens, xsph = tls.sweep_a2(*a_in, lo, hi, cfg, sub_q=sub_q)
    b_in = _raw_b_inputs(a_in, dens, xsph, st.vm[order], cfg)
    qb, feats_b = tls._inputs_b(*b_in)
    cat = lambda *t: torch.cat([x.reshape(x.shape[0], -1)  # noqa: E731
                                for x in t], dim=1)
    runs["K9 A"] = (lambda: cat(*tls.sweep_a2(*a_in, lo, hi, cfg,
                                              sub_q=sub_q)),
                    lambda q: tls._plain_a2(q, feats_a, cfg), qa)
    runs["K9 B"] = (lambda: cat(*tls.sweep_b2(*b_in, lo, hi, cfg,
                                              sub_q=sub_q)),
                    lambda q: tls._plain_b2(q, feats_b, cfg), qb)
    return runs


@pytest.mark.parametrize("case", ["blob", "sparse", "isolated",
                                  "biceps_full"])
def test_hash9_kernels_match_plain(device, case):
    """The hash-walk sweeps (K6 A / B with and without EP and with dynp; K9
    A / B) against their plain versions at every sub_q the wrappers accept
    (on "sparse" the sub-blocks' nine windows overlap), two launches of
    each bitwise equal, one launch counted per call."""
    cfg, st, sub_qs = _redesign_state(device, case)
    dynp = fst.build_dynp(T.resolve_params(cfg, {"k_stiffness": 0.8,
                                                 "mu_viscosity": 40.0}),
                          device)
    counters = (fst.sweep_a3_hash9, fst.sweep_b3_hash9, tls.sweep_a2,
                tls.sweep_b2)
    for sub_q in sub_qs:
        runs = _hash9_runs(st, cfg, sub_q, dynp)
        before = [k.launches for k in counters]
        for name, (launch, plain, qm) in runs.items():
            got, again = launch(), launch()
            torch.cuda.synchronize()
            _check(got, plain(qm), f"{case} sub_q {sub_q} {name}")
            assert torch.equal(got, again), (case, sub_q, name)
        assert [k.launches - b for k, b in zip(counters, before)] == \
            [6, 6, 2, 2]


def _v1_runs(st, cfg, sub_q):
    """{label: (launch, plain(query rows))} of the v1 run sweeps K8 A / B on
    a state's v1 bookkeeping; sweep B's inputs come from the sweep-A kernel,
    and each plain call takes only its rows' candidates
    (legacy_sweeps.plain_on_run_rows)."""
    order, _, qs, qe, bs, bl = tls.sweep_bookkeeping(st.pos, st.active, cfg,
                                                     sub_q)
    a_in = _raw_inputs(st, order, torch.zeros_like(st.mass), cfg)[:4]
    qa, feats_a = tls._inputs_a(*a_in)
    dens, xsph = tls.sweep_a(*a_in, qs, qe, bs, bl, cfg)
    b_in = _raw_b_inputs((*a_in, None), dens, xsph, st.vm[order], cfg)[:5]
    qb, feats_b = tls._inputs_b(*b_in)
    cat = lambda *t: torch.cat([x.reshape(x.shape[0], -1)  # noqa: E731
                                for x in t], dim=1)

    def plain(fn, qm, feats):
        return lambda r: tls.plain_on_run_rows(lambda *a: fn(*a, cfg), qm,
                                               feats, qs, qe, r)
    return {"K8 A": (lambda: cat(*tls.sweep_a(*a_in, qs, qe, bs, bl, cfg)),
                     plain(tls._plain_a1, qa, feats_a)),
            "K8 B": (lambda: cat(*tls.sweep_b(*b_in, qs, qe, bs, bl, cfg)),
                     plain(tls._plain_b1, qb, feats_b))}


@pytest.mark.parametrize("replicate", [2, 4, 8, 16])
def test_redesigned_kernels_every_slice_count(device, replicate):
    """K1-K5, K6 A / B (with and without EP and with dynp), K8 A / B and K9
    A / B on biceps_full tiled 2, 4, 8 and 16 times (37k to 296k particles), where
    the launch takes 8, 4, 2 and 2 warp slices a row warp on the H100's 132
    SMs (biceps_full itself takes 16): held to their plain versions on 64
    sampled warps of rows (K4 and K5 on seeded random cotangents), and two
    launches of each bitwise equal."""
    sc = T.build_scene("biceps_full", replicate=replicate, device=device)
    cfg, sq, n = sc.cfg, sc.sub_block, sc.state.capacity
    w = torch.linspace(0, n // 32 - 1, 64, device=device).long()
    rows = (w[:, None] * 32 + torch.arange(32, device=device)).reshape(-1)
    rng = np.random.default_rng(replicate)
    vm = torch.from_numpy(rng.normal(size=n).astype(np.float32)
                          * 10.0).to(device)
    st = sc.state.replace(vm=vm)
    tab = variants.monodomain_prepare_fused(st, cfg, sub_q=sq)
    vm_s = vm[tab.order]
    qm, feats = variants._lap_inputs(vm_s, tab.vol_s, vm_s, tab.pos_s,
                                     tab.cx_s, tab.cyz_s)
    got = fst.sweep_lap3(qm, feats, tab.blk_lo, tab.blk_hi, cfg, sq)
    again = fst.sweep_lap3(qm, feats, tab.blk_lo, tab.blk_hi, cfg, sq)
    torch.cuda.synchronize()
    # the plain versions size their chunks by the query count alone: 32
    # query rows a call keep each chunk small against 296k candidates
    _check(got[rows], torch.cat([fst.sweep_lap3_plain(qm[r], feats, cfg)
                                 for r in rows.split(32)]),
           f"x{replicate} K3")
    assert torch.equal(got, again)
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg, sq)
    fs, fa = fst.build_qm_feats(st, cx, cyz, order)
    out_a = fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sq)
    again = fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sq)
    torch.cuda.synchronize()
    _check(out_a[rows], torch.cat([fst.sweep_a3_plain(fs[r], fa, cfg)
                                   for r in rows.split(32)]),
           f"x{replicate} K1")
    assert torch.equal(out_a, again)
    fb = fst.feats_b(out_a)
    got = fst.sweep_b3(out_a, fb, lo, hi, cfg, sub_q=sq)
    again = fst.sweep_b3(out_a, fb, lo, hi, cfg, sub_q=sq)
    torch.cuda.synchronize()
    _check(got[rows], torch.cat([fst.sweep_b3_plain(out_a[r], fb, cfg)
                                 for r in rows.split(32)]),
           f"x{replicate} K2")
    assert torch.equal(got, again)
    cot = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    qa = fad.bwd_a_query(fs, cot(n), cot(n, 3))
    qb = fad.bwd_b_query(out_a, cot(n, 3), cot(n))
    for name, qm, kernel, plain in (
            ("K4", qa, fad.sweep_bwd_a, fad.sweep_bwd_a_plain),
            ("K5", qb, fad.sweep_bwd_b, fad.sweep_bwd_b_plain)):
        feats = qm.T.contiguous()
        got = kernel(qm, feats, lo, hi, cfg, sq)
        again = kernel(qm, feats, lo, hi, cfg, sq)
        torch.cuda.synchronize()
        _check(got[rows], torch.cat([plain(qm[r], feats, cfg)
                                     for r in rows.split(32)]),
               f"x{replicate} {name}")
        assert torch.equal(got, again), name
    dynp = fst.build_dynp(T.resolve_params(cfg, {"k_stiffness": 0.8,
                                                 "mu_viscosity": 40.0}),
                          device)
    for name, (launch, plain, qm) in _hash9_runs(st, cfg, sq, dynp).items():
        got, again = launch(), launch()
        torch.cuda.synchronize()
        _check(got[rows], torch.cat([plain(qm[r]) for r in rows.split(32)]),
               f"x{replicate} {name}")
        assert torch.equal(got, again), name
    for name, (launch, plain) in _v1_runs(st, cfg, sq).items():
        got, again = launch(), launch()
        torch.cuda.synchronize()
        _check(got[rows], torch.cat([plain(r) for r in rows.split(32)]),
               f"x{replicate} {name}")
        assert torch.equal(got, again), name


def test_lap_vm_grad_on_card_matches_cpu(device):
    """d loss / d vm0 of a 3-step fused monodomain rollout through LapVmFn:
    the card (kernel forward and backward) against the CPU (plain
    version), and the launches of one value-and-grad on the card: the
    prepare's one, then one forward and one backward per step."""
    cfg, st = _blob(device, n=600, seed=3)
    rng = np.random.default_rng(4)
    wgt = rng.normal(size=st.capacity).astype(np.float32)
    vm0 = rng.normal(size=st.capacity).astype(np.float32) * 5.0
    steps = 3

    def value_and_grad(s0):
        d = s0.device
        tab = variants.monodomain_prepare_fused(s0, cfg)
        vm = torch.from_numpy(vm0).to(d).requires_grad_()
        out = variants.simulate_monodomain_only_fused(s0.replace(vm=vm), tab,
                                                      cfg, steps)
        val = torch.where(out.active, out.vm * torch.from_numpy(wgt).to(d),
                          torch.zeros_like(out.vm)).sum()
        (g,) = torch.autograd.grad(val, vm)
        return float(val.detach()), g.cpu().numpy()

    n0 = fst.sweep_lap3.launches
    vc, gc = value_and_grad(st)
    assert fst.sweep_lap3.launches - n0 == 1 + 2 * steps
    vp, gp = value_and_grad(st.to("cpu"))
    np.testing.assert_allclose(vc, vp, rtol=1e-5)
    assert np.abs(gp).max() > 0
    np.testing.assert_allclose(gc, gp, atol=1e-4 * max(1.0,
                                                       np.abs(gp).max()))


@pytest.mark.parametrize("case", ["v1", "v1_sub_q32", "v2", "v2_sub_q128"])
@pytest.mark.parametrize("state", ["blob", "sparse", "isolated",
                                   "biceps_full"])
def test_v1_v2_kernels_match_plain(device, state, case):
    """The v1 (per-query runs: K8) and v2 (hash9 windows: K9) raw-sum sweep
    kernels against their plain versions on the states of _redesign_state
    (a blob with padding rows, two far clusters, scattered particles,
    biceps_full), sweep B on inputs derived from the plain sweep A; two
    launches of each bitwise equal, each launch counted."""
    impl = case[:2]
    sub_q = {"v1": 128, "v1_sub_q32": 32, "v2": 32, "v2_sub_q128": 128}[case]
    cfg, st, _ = _redesign_state(device, state)
    if impl == "v1":
        order, _, qs, qe, bs, bl = tls.sweep_bookkeeping(st.pos, st.active,
                                                         cfg, sub_q)
        extra, kbounds, pbounds = (), (qs, qe, bs, bl), (qs, qe)
        kernels = (tls.sweep_a, tls.sweep_b)
        plains = (tls.sweep_a_plain, tls.sweep_b_plain)
    else:
        order, _, lo, hi, chash = sweep_bookkeeping2(st.pos, st.active, cfg,
                                                     sub_q)
        extra, kbounds, pbounds = (chash[order],), (lo, hi), ()
        kernels = (tls.sweep_a2, tls.sweep_b2)
        plains = (tls.sweep_a2_plain, tls.sweep_b2_plain)
    pos, cvel, mass, dens = (st.pos[order], st.corrected_vel[order],
                             st.mass[order], st.dens[order])
    vol = fst._safe_div(mass, dens, dens > 0.0)
    before = [k.launches for k in kernels]
    a_in = (pos, cvel, vol, mass, *extra)
    want_a = plains[0](*a_in, *pbounds, cfg)
    got_a = kernels[0](*a_in, *kbounds, cfg, sub_q=sub_q)
    again_a = kernels[0](*a_in, *kbounds, cfg, sub_q=sub_q)
    cat = lambda d, x: torch.cat([d[:, None], x], dim=1)  # noqa: E731
    _check(cat(*got_a), cat(*want_a), f"{state} {case} A")
    assert torch.equal(cat(*got_a), cat(*again_a)), (state, case)
    d_now, xsph = want_a
    g = fst._safe_div(mass, d_now, d_now > 0.0)
    pres = cfg.k_stiffness * (d_now - cfg.stand_density)
    b_in = (pos, cvel + xsph * cfg.velocity_mixing, g, pres,
            st.vm[order], *extra)
    want_b = plains[1](*b_in, *pbounds, cfg)
    got_b = kernels[1](*b_in, *kbounds, cfg, sub_q=sub_q)
    again_b = kernels[1](*b_in, *kbounds, cfg, sub_q=sub_q)
    torch.cuda.synchronize()
    cat_b = lambda x, lap: torch.cat([x, lap[:, None]], dim=1)  # noqa: E731
    _check(cat_b(*got_b), cat_b(*want_b), f"{state} {case} B")
    assert torch.equal(cat_b(*got_b), cat_b(*again_b)), (state, case)
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2]


@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_v1_v2_step_on_card_matches_cpu(device, impl):
    """Two v1 / v2 steps on the card (kernels) against the CPU (plain
    versions), at the JAX suite's fused-step tolerances."""
    cfg, st = _blob(device, n=600, seed=3)
    got, want = st, st.to("cpu")
    for _ in range(2):
        got, aux = T.step_fused(got, cfg, impl=impl)
        want, _ = T.step_fused(want, cfg, impl=impl)
        assert int(aux.overflow) == 0
    g, w = T.state_to_numpy(got), T.state_to_numpy(want)
    act = w["active"]
    for name, atol in (("pos", 5e-5), ("vel", 5e-3), ("vm", 5e-3),
                       ("iion", 1e-5), ("w", 1e-6)):
        np.testing.assert_allclose(g[name][act], w[name][act], atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(g["dens"][act], w["dens"][act], rtol=1e-5)


@pytest.mark.parametrize("iters", [0, 1, 256])
def test_fma_chains_kernel_matches_plain(device, iters):
    """The FMA-chain probe (K10) against its plain version at the probe's
    input shape, within FMA_ULP_TOL float32 ulps."""
    n = roofline.fma_probe_input(device).numel()
    x = torch.from_numpy(np.random.default_rng(iters).standard_normal(
        n).astype(np.float32)).to(device)
    n0 = roofline.fma_chains.launches
    got = roofline.fma_chains(x, iters)
    want = roofline.fma_chains_plain(x, iters)
    torch.cuda.synchronize()
    assert roofline.fma_chains.launches == n0 + 1
    assert torch.isfinite(got).all()
    ulps = roofline.ulp_error(got, want)
    assert ulps <= roofline.FMA_ULP_TOL, ulps


def test_measure_vpu_peak_on_card(device):
    """The probe's FLOP/s is positive and below twice the data sheet."""
    peak = roofline.measure_vpu_peak(device, reps=1)
    assert 0.0 < peak < 2 * roofline.PEAK_FLOPS
