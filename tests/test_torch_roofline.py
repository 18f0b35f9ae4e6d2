"""The port's roofline tool (sph_sm_monodomain_tpu_torch/tools/roofline.py)
against the JAX repository's tools/roofline.py, on the CPU.

- fma_chains_plain, the plain version of the FMA-chain probe (K10), is bit
  equal to a numpy transcription of the JAX probe's kernel
  (tools/roofline.py:79-89: chains x * (1 + 0.001 k), then a = a *
  1.0000001 + 0.5, summed in chain order) with each chain step rounded to
  float32 once, as the CUDA kernel's fmaf rounds it; on a few elements it
  equals an exact rational fmaf, correctly rounded; ulp_error, the check
  the kernel is held to, rejects a kernel that drops the multiply or the
  chains' start multipliers, or rounds twice; the wrapper takes the plain
  version on a CPU tensor without launching anything.
- scene_slot_stats equals the JAX tool's, loaded by path (the tools/
  directory is not a package), on the biceps slice for the v4 windows and
  the v5 slabs.
- pair_counts, the pairs the sweeps need (the roofline's and
  chip_smoke.py's FLOP counts), equals a brute-force count over all pairs
  of the slice's live particles within one cell on every axis, at every
  sub-block size.
- measure_vpu_peak raises without a GPU: the probe has no CPU timing.
"""

import importlib.util
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from sph_sm_monodomain_tpu_torch.tools import roofline as troof

from sph_sm_monodomain_tpu_torch.ops.fused_step import build_qm_feats
from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3

from torch_parity import (biceps_slice_points, named_state, torch_cfg,
                          to_torch_state)

JAX_TOOL = Path(__file__).resolve().parents[1] / "tools" / "roofline.py"


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_roofline_tool",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_chains(x, iters, chains):
    """tools/roofline.py:79-89 in numpy, each chain step a * 1.0000001 +
    0.5 taken in float64 (the product of two float32 is exact there) and
    rounded to float32 once, as fmaf rounds it."""
    m = np.float64(np.float32(1.0000001))
    accs = [x * np.float32(1.0 + 0.001 * k) for k in range(chains)]
    for _ in range(iters):
        accs = [(a.astype(np.float64) * m + 0.5).astype(np.float32)
                for a in accs]
    return sum(accs)


def _round_f32(v: Fraction) -> np.float32:
    """The float32 nearest the rational v, ties to even."""
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - v) for c in cands]
    best = min(dist)
    near = [c for c, d in zip(cands, dist) if d == best]
    return min(near, key=lambda c: int(np.float32(c).view(np.uint32)) & 1)


def _exact_chains(x, iters, chains):
    """fmaf chains in exact rationals, each step correctly rounded."""
    m, half = Fraction(float(np.float32(1.0000001))), Fraction(1, 2)
    out = []
    for xi in x:
        accs = [xi * np.float32(1.0 + 0.001 * k) for k in range(chains)]
        for _ in range(iters):
            accs = [_round_f32(Fraction(float(a)) * m + half) for a in accs]
        s = accs[0]
        for a in accs[1:]:
            s = np.float32(s + a)
        out.append(s)
    return np.array(out, np.float32)


@pytest.mark.parametrize("iters,chains", [(0, 16), (1, 16), (300, 16),
                                          (257, 3)])
def test_fma_chains_plain_bit_equal_numpy(iters, chains):
    x = np.random.default_rng(iters).standard_normal(1024).astype(np.float32)
    got = troof.fma_chains_plain(torch.from_numpy(x), iters, chains).numpy()
    want = _numpy_chains(x, iters, chains)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fma_chains_plain_equals_exact_fmaf():
    """Inputs near 0 and negative ones, whose chains cross 0: each step of
    the plain version is the correctly rounded a * 1.0000001f + 0.5f."""
    x = np.concatenate([np.float32([1e-9, -1e-7, 2.0 ** -7, -0.75, -3.0]),
                        np.random.default_rng(5).standard_normal(
                            11).astype(np.float32)])
    got = troof.fma_chains_plain(torch.from_numpy(x), 60, 4).numpy()
    want = _exact_chains(x, 60, 4)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _mutant_chains(x, iters, mult, step):
    chains = troof.FMA_CHAINS
    accs = [x * np.float32(mult(k)) for k in range(chains)]
    for _ in range(iters):
        accs = [step(a) for a in accs]
    return torch.from_numpy(sum(accs))


@pytest.mark.parametrize("mutant", ["no_multiply", "start_multipliers",
                                    "two_roundings"])
def test_fma_ulp_check_rejects_mutants(mutant):
    """The K10 check (ulp_error <= FMA_ULP_TOL, at the card's comparison
    length) catches a kernel computing another function."""
    x = np.random.default_rng(23).standard_normal(4096).astype(np.float32)
    iters = 256
    mult = {"start_multipliers": lambda k: 1.0}.get(
        mutant, lambda k: 1.0 + 0.001 * k)
    f32 = np.float32
    step = {"no_multiply": lambda a: a + f32(0.5),
            "two_roundings": lambda a: a * f32(1.0000001) + f32(0.5)}.get(
        mutant, lambda a: (a.astype(np.float64)
                           * np.float64(f32(1.0000001)) + 0.5).astype(f32))
    want = troof.fma_chains_plain(torch.from_numpy(x), iters)
    assert troof.ulp_error(want, want) == 0.0
    assert troof.ulp_error(_mutant_chains(x, iters, mult, step),
                           want) > troof.FMA_ULP_TOL


def test_fma_chains_wrapper_on_cpu():
    """On a CPU tensor the wrapper runs the plain version (FMA_CHAINS
    chains) and launches nothing; it rejects what the kernel does not
    take."""
    x = torch.linspace(-1.0, 1.0, 640)
    before = troof.fma_chains.launches
    got = troof.fma_chains(x, 40)
    assert torch.equal(got, troof.fma_chains_plain(x, 40, troof.FMA_CHAINS))
    assert troof.fma_chains.launches == before
    with pytest.raises(ValueError):
        troof.fma_chains(x.double(), 4)
    with pytest.raises(ValueError):
        troof.fma_chains(x.reshape(2, -1), 4)


@pytest.mark.parametrize("impl,sub_q,kb", [("v4", 128, 0), ("v4", 64, 0),
                                           ("v5", 32, 512), ("v5", 16, 0)])
def test_scene_slot_stats_matches_jax_tool(impl, sub_q, kb):
    jtool = _jax_tool()
    jcfg, _ = named_state("slice")
    pts = biceps_slice_points(every=40)
    want = jtool.scene_slot_stats(pts, jcfg, impl, sub_q, kb)
    got = troof.scene_slot_stats(pts, torch_cfg(jcfg), impl, sub_q, kb)
    want.pop("_sample")  # the JAX report's subsample; the port counts all
    assert got == want


def test_scene_slot_stats_wide_world_matches_jax_tool():
    """A stretched world, where the hash axes permute (hash_axis_perm)."""
    jtool = _jax_tool()
    jcfg, js = named_state("wide_world")
    pts = np.asarray(js.pos)[np.asarray(js.active)]
    for impl in ("v4", "v5"):
        want = jtool.scene_slot_stats(pts, jcfg, impl, 32)
        got = troof.scene_slot_stats(pts, torch_cfg(jcfg), impl, 32)
        want.pop("_sample")
        assert got == want, impl


def _brute_pairs(pos, live, cfg):
    """All ordered pairs of live particles within one cell on every axis
    (self pairs included), in float32 as the sweeps see them."""
    p = pos[live]
    c = np.floor(p / np.float32(cfg.cell_size)).astype(np.int64)
    near = (np.abs(c[:, None, :] - c[None, :, :]) <= 1).all(-1)
    d = p[:, None, :] - p[None, :, :]
    r2 = (d * d).sum(-1)
    h2 = np.float32(cfg.kernel_h * cfg.kernel_h)
    return {"full": int(near.sum()), "h": int((near & (r2 < h2)).sum()),
            "2h": int((near & (r2 > 1e-12) & (r2 < 4 * h2)).sum())}


@pytest.mark.parametrize("name,sub_q", [("slice", 128), ("slice", 32),
                                        ("wide_world", 128)])
def test_pair_counts_equal_brute_force(name, sub_q):
    jcfg, js = named_state(name)
    cfg, st = torch_cfg(jcfg), to_torch_state(js)
    order, _, lo, hi, cx, cyz = sweep_bookkeeping3(st.pos, st.active, cfg,
                                                   sub_q)
    fs, _ = build_qm_feats(st, cx, cyz, order)
    got = troof.pair_counts(fs, lo, hi, cfg, sub_q)
    want = _brute_pairs(st.pos.numpy(), st.active.numpy(), cfg)
    assert got == want
    assert got["full"] >= max(got["2h"], got["h"]) and min(got.values()) > 0


def test_measure_vpu_peak_raises_without_gpu():
    with pytest.raises(RuntimeError):
        troof.measure_vpu_peak(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            troof.measure_vpu_peak()
