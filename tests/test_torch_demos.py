"""The port's numpy render, animation and mesh mirrors against the JAX
package's modules (byte for byte on the same numpy state), and CPU smokes
of the port's contraction, stimulus-fit and material-fit demos (susane, a
few steps and iterations; the full recovery runs are card tests in
tests/test_torch_cuda.py and chip_smoke phase 28)."""

import re
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.utils import animate as janim
from sph_sm_monodomain_tpu.utils import io as jio
from sph_sm_monodomain_tpu.utils import render as jren
from sph_sm_monodomain_tpu_torch.examples import (contraction_demo,
                                                  fit_material_demo,
                                                  fit_stimulus_demo)
from sph_sm_monodomain_tpu_torch.utils import animate as tanim
from sph_sm_monodomain_tpu_torch.utils import io as tio
from sph_sm_monodomain_tpu_torch.utils import render as tren

from torch_parity import to_torch_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small ops: beside the suite's other parallel workers, torch's
    intra-op thread pool oversubscribes the cores (as in
    tests/test_torch_adjoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moved():
    """(JAX config, JAX state, port state) of susane with its particles
    moved off the rest shape and random voltages, so both colormaps span
    their ranges."""
    sc = J.build_scene("susane")
    rng = np.random.default_rng(4)
    js = sc.state
    pos = np.asarray(js.pos).copy()
    act = np.asarray(js.active)
    pos[act] += rng.normal(size=(int(act.sum()), 3)).astype(np.float32) \
        * 0.03
    vm = (rng.normal(size=js.vm.shape) * 80.0).astype(np.float32)
    js = js.replace(pos=pos, vm=vm)
    return sc.cfg, js, to_torch_state(js)


def test_set_color_matches_jax():
    v = np.random.default_rng(1).normal(size=(1000,)).astype(np.float32) \
        * 0.06
    assert np.array_equal(tren.set_color(v, -0.05, 0.05),
                          jren.set_color(v, -0.05, 0.05))


@pytest.mark.parametrize("kw", [
    dict(), dict(mode="voltage", azimuth=0.4, elevation=0.25),
    dict(mode="voltage", vrange=(0.0, 15.0), point_px=3),
    dict(fade_ratio=0.5, world_box=True, size=200, azimuth=1.1)],
    ids=["displacement", "voltage", "voltage_range", "fade_box"])
def test_render_points_matches_jax(moved, kw):
    cfg, js, ts = moved
    got = tren.render_points(ts, cfg, **kw)
    want = jren.render_points(js, cfg, **kw)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 10


def test_render_mesh_and_frames_match_jax(moved, tmp_path):
    cfg, js, ts = moved
    faces = tio.load_surface_mesh("biceps")[0]
    faces = faces[faces.max(axis=1) < int(np.asarray(js.active).sum())]
    assert np.array_equal(tren.render_mesh(ts, cfg, faces, size=160),
                          jren.render_mesh(js, cfg, faces, size=160))
    tp = tren.render_frames([ts, ts], cfg, str(tmp_path / "t"), 1, size=96)
    jp = jren.render_frames([js, js], cfg, str(tmp_path / "j"), 1, size=96)
    for a, b in zip(tp, jp):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert np.array_equal(tanim.read_png_rgb(a), janim.read_png_rgb(b))


@pytest.mark.parametrize("which", ["biceps", "rectus_femoris"])
def test_load_surface_mesh_matches_jax(which):
    got, want = tio.load_surface_mesh(which), jio.load_surface_mesh(which)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        tio.load_surface_mesh("cube")


def test_write_gif_and_ppm_match_jax_without_pil(moved, tmp_path):
    """With PIL hidden on both sides: the hand-written GIF encoder and the
    PPM fallback of save_png give the JAX package's bytes, and read back."""
    cfg, js, ts = moved
    frames = [tren.render_points(ts, cfg, size=64, azimuth=a)
              for a in (0.0, 0.7, 1.4)]
    with mock.patch.dict(sys.modules, {"PIL": None}):
        tanim.write_gif(str(tmp_path / "t.gif"), frames, fps=10)
        janim.write_gif(str(tmp_path / "j.gif"), frames, fps=10)
        tp = tren.save_png(str(tmp_path / "t.png"), frames[1])
        jp = jren.save_png(str(tmp_path / "j.png"), frames[1])
        assert tp.endswith(".ppm") and jp.endswith(".ppm")
        assert np.array_equal(tanim.read_png_rgb(tp), frames[1])
    data = (tmp_path / "t.gif").read_bytes()
    assert data[:6] == b"GIF89a" and data == (tmp_path / "j.gif").read_bytes()
    assert (tmp_path / "t.ppm").read_bytes() \
        == (tmp_path / "j.ppm").read_bytes()


def test_contraction_demo_cpu_smoke(tmp_path, capsys):
    """susane, 4 steps: one frame a step (record_every = 1), finite state."""
    res = contraction_demo.main(["susane", "4", "--device", "cpu", "--out",
                                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "susane: 507 particles" in out and "overflow=0" in out
    assert re.search(r"4 frames -> ", out)
    assert len(res["frames"]) == 4
    assert all((tmp_path / "frames" / f"frame_{i:05d}.png").is_file()
               for i in range(1, 5))
    assert np.isfinite(res["state"].pos.numpy()).all()


def test_fit_stimulus_demo_cpu_smoke(capsys):
    """4 steps, 2 Newton iterations: the recovery line the JAX suite parses
    (tests/test_examples.py:80-90), within its 1%."""
    res = fit_stimulus_demo.main(["4", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"recovered amplitude .* \(([\d.]+)% off\)", out)
    assert m, out[-300:]
    assert float(m.group(1)) < 1.0 and res["err"] < 0.01


def test_fit_material_demo_cpu_smoke(capsys):
    """3 steps, 2 Adam iterations: the loss falls, the recovery line the
    JAX suite parses (tests/test_examples.py:61-64) is printed, and the
    demo exits with its error, as the JAX demo does whenever K or mu is
    more than 20% off (2 iterations do not get there)."""
    with pytest.raises(SystemExit, match="did not converge"):
        fit_material_demo.main(["3", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"recovered K=([\d.]+) .*mu=([\d.]+)", out)
    assert m, out[-300:]
    assert np.isfinite([float(m.group(1)), float(m.group(2))]).all()
    losses = [float(v) for v in re.findall(r"loss\s+([\d.e+-]+)", out)]
    assert len(losses) == 2 and losses[1] < losses[0]
