"""PyTorch port vs the JAX package: the print_report row
(utils/report.py). REPORT_HEADER and report_row must be byte-equal to the
JAX package's for the same config, step count, time and phases; each
profiler must return the JAX profiler's keys, every column finite and
>= 0, and the incremental attribution of the fused ones must reconcile
with its raw pipelines (after tests/test_aux.py:94-150, 253-269): the
first pipeline plus each clamped stage difference, equal to the full step
when no difference was clamped. Chains are 2 calls long on the CPU, where
the suite's parallel workers make each time noisy, so the JAX suite's
[0.5, 1.5] x the step band is checked on the card (chip_smoke phase 29),
not here."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.utils import report as jrep
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.utils import report as trep

from torch_parity import torch_cfg

PHASES = ("find_neighbors", "corrected_velocity", "intermediate_velocity",
          "density_pressure", "cell_model", "compute_force",
          "update_properties")
FUSED_KEYS = set(PHASES) | {"total_step", "raw_pipeline_s"}
SCENE_SMALL = "susane"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Timed chains of small ops beside the suite's parallel workers (as
    in tests/test_torch_adjoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def susane():
    return T.build_scene(SCENE_SMALL, device="cpu")


def test_report_header_is_the_jax_header():
    assert trep.REPORT_HEADER == jrep.REPORT_HEADER
    assert len(trep.REPORT_HEADER.split(";")) == 23


_PH = {"find_neighbors": 1.25e-4, "corrected_velocity": 3.5e-5,
       "intermediate_velocity": 0.0, "density_pressure": 2.0e-4,
       "cell_model": 0.0, "compute_force": 3.1e-4,
       "update_properties": 0.0, "total_step": 6.7e-4,
       "raw_pipeline_s": (1.25e-4, 1.6e-4, 3.6e-4, 6.7e-4)}


@pytest.mark.parametrize("case", ["default", "sph", "dynamic", "fps",
                                  "zero_step", "no_phases"])
def test_report_row_is_the_jax_row(case):
    jcfg = J.SimConfig()
    args = (500, 6.7e-4, _PH)
    kw = {}
    if case == "sph":
        jcfg = J.models.variants.sph_only_config(jcfg)
    elif case == "dynamic":
        jcfg = J.resolve_params(jcfg, {"mu_viscosity": 50.0,
                                       "k_stiffness": 0.8})
    elif case == "fps":
        kw = {"avg_fps": 61.5}
    elif case == "zero_step":
        args = (3, 0.0, _PH)
    elif case == "no_phases":
        args = (250, 0.0123, {})
    tcfg = torch_cfg(jcfg)
    row = trep.report_row(tcfg, *args, **kw)
    assert row == jrep.report_row(jcfg, *args, **kw)
    assert len(row.split(";")) == 23


def _check(ph, keys):
    assert set(ph) == keys
    for k in PHASES:
        assert np.isfinite(ph[k]) and ph[k] >= 0.0, (k, ph)


def _check_reconciles(ph, live):
    """The live columns are the first raw pipeline and each clamped stage
    difference, in order; their sum is the full step when none was
    clamped, and never below it."""
    raw = ph["raw_pipeline_s"]
    assert ph["total_step"] == raw[-1] > 0.0
    assert [ph[k] for k in live] == [raw[0]] + [
        max(b - a, 0.0) for a, b in zip(raw, raw[1:])]
    attributed = sum(ph[k] for k in live)
    if all(b >= a for a, b in zip(raw, raw[1:])):
        assert attributed == pytest.approx(ph["total_step"], rel=1e-9)
    assert attributed >= ph["total_step"] * (1 - 1e-9)


def test_profile_phases_unfused_covers_all_seven(susane):
    """The unfused profiler times each of the reference's 7 phases
    (cpp:794-824) and returns positive seconds for each, as JAX's."""
    ph = trep.profile_phases(susane.state, susane.cfg,
                             susane.neighbor_capacity, length=2)
    _check(ph, set(PHASES))
    assert all(v > 0 for v in ph.values()), ph


def test_profile_phases_fused_schema_and_reconciliation(susane):
    ph = trep.profile_phases_fused(susane, length=2)
    _check(ph, FUSED_KEYS)
    assert len(ph["raw_pipeline_s"]) == 4
    for k in ("intermediate_velocity", "cell_model", "update_properties"):
        assert ph[k] == 0.0
    _check_reconciles(ph, ("find_neighbors", "corrected_velocity",
                           "density_pressure", "compute_force"))


def test_profile_phases_sph_fused_schema(susane):
    ph = trep.profile_phases_sph_fused(susane, length=2)
    _check(ph, FUSED_KEYS)
    assert len(ph["raw_pipeline_s"]) == 3
    for k in ("corrected_velocity", "intermediate_velocity", "cell_model",
              "update_properties"):
        assert ph[k] == 0.0
    _check_reconciles(ph, ("find_neighbors", "density_pressure",
                           "compute_force"))


def test_profile_phases_monodomain_fused_schema(susane):
    ph = trep.profile_phases_monodomain_fused(susane, length=2)
    _check(ph, FUSED_KEYS)
    for k in ("find_neighbors", "corrected_velocity",
              "intermediate_velocity", "density_pressure",
              "update_properties"):
        assert ph[k] == 0.0
    _check_reconciles(ph, ("cell_model", "compute_force"))


def test_profile_phases_fused_v5(susane):
    """The v5 scene's pipelines (slab bookkeeping, packed sweep A)."""
    sc = T.build_scene("susane", fused_impl="v5", device="cpu")
    ph = trep.profile_phases_fused(sc, length=2)
    _check(ph, FUSED_KEYS)
    _check_reconciles(ph, ("find_neighbors", "corrected_velocity",
                           "density_pressure", "compute_force"))
    with pytest.raises(ValueError):
        trep.profile_phases_fused(susane._replace(fused_impl="v3"), length=2)


def test_iter_cost_and_auto_length_take_chain_differences(monkeypatch):
    """_iter_cost reads a body's own cost from two chain lengths, and
    _auto_length sizes chains so the cheap body accumulates ~50 ms. The
    CPU chains are timed with report's time.perf_counter, which a virtual
    clock replaces here: each body call advances it by the body's cost (powers
    of two, so every difference is exact), so the arithmetic is held
    exactly whatever the host's load."""
    clock = {"t": 1024.0}
    monkeypatch.setattr(trep, "time",
                        SimpleNamespace(perf_counter=lambda: clock["t"]))
    t_cheap, t_full = 2.0 ** -8, 2.0 ** -5

    def costing(cost):
        def body(x):
            clock["t"] += cost
            return x + 1.0
        return body

    cheap, full = costing(t_cheap), costing(t_full)
    x = torch.zeros(4)
    assert trep._iter_cost(cheap, x) == t_cheap
    assert trep._iter_cost(full, x) == t_full
    n = trep._auto_length(cheap, full, x)
    assert n == max(4, int(min(250, 0.05 / t_cheap, 3.0 / t_full))) == 12


# --- the measuring tools (after tests/test_aux.py:271-406), on the CPU ------

def _jax_tool(name):
    """The JAX repository's tools/<name>.py as a module (its tools import
    jax only inside their functions)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_summarize_is_the_jax_summary(tmp_path, capsys):
    """--summarize on the committed campaign writes the JAX tool's text."""
    from pathlib import Path
    from sph_sm_monodomain_tpu_torch.tools import sweep
    csv = str(Path(__file__).resolve().parents[1] / "results_tpu_sweep.csv")
    assert sweep.main(["--summarize", "--out", csv, "--summary-out",
                       str(tmp_path / "t.md")]) == 0
    assert _jax_tool("sweep").summarize(csv, str(tmp_path / "j.md")) == 0
    text = (tmp_path / "t.md").read_text()
    assert text == (tmp_path / "j.md").read_text()
    assert "| K |" in text and "phases sum to" in text


def test_bench_rows_campaign_turns_the_stimulus_off_at_half(monkeypatch):
    """The campaign rows run run_protocol with stim_off_step = steps // 2,
    as the reference app does (the JAX tool passes 250 whatever the
    length), at the two campaign configurations."""
    from sph_sm_monodomain_tpu_torch.tools import bench_rows
    calls = []

    def fake_run_protocol(sc, num_steps, stim_off_step, chunk):
        calls.append((num_steps, stim_off_step, sc.cfg.k_stiffness,
                      sc.cfg.stim_strength, round(sc.cfg.sigma, 4)))
        return sc.state, T.StepAux(overflow=torch.tensor(0)), None

    monkeypatch.setattr(bench_rows, "run_protocol", fake_run_protocol)
    monkeypatch.setattr(bench_rows, "profile_phases_fused",
                        lambda sc, **kw: dict(_PH))
    rows = bench_rows.campaign_rows({}, "cpu", log=lambda m: None)
    assert calls == [(2000, 1000, 0.8, 500000.0, 1.0),
                     (1000, 500, 0.8, 800000.0, 0.3828)]
    for row in rows:
        cols = row.split(";")
        assert len(cols) == len(bench_rows.HEADER.split(";")) == 26
        assert cols[0] == "biceps_18475" and cols[1] == "5211"
        assert cols[-1] == "measured"


def test_bench_rows_tool_smoke(tmp_path, monkeypatch):
    """One short coupled row and one row of each variant mode, in
    results_tpu.csv's schema: the step column and the seven phase columns
    are the mode profiler's own, whose attribution reconciles."""
    from sph_sm_monodomain_tpu_torch.tools import bench_rows
    seen = []
    for name in ("profile_phases_fused", "profile_phases_sph_fused",
                 "profile_phases_monodomain_fused"):
        real = getattr(bench_rows, name)
        monkeypatch.setattr(bench_rows, name, lambda sc, _f=real, **kw:
                            seen.append(_f(sc, **kw)) or seen[-1])
    out = tmp_path / "rows.csv"
    bench_rows.main(["--scenes", "susane::4", "--profile-length", "2",
                     "--modes", "coupled,sph,monodomain", "--device", "cpu",
                     "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == bench_rows.HEADER
    assert [ln.split(";")[0] for ln in lines[1:]] == [
        "susane", "susane[sph]", "susane[monodomain]"]
    live = (("find_neighbors", "corrected_velocity", "density_pressure",
             "compute_force"),
            ("find_neighbors", "density_pressure", "compute_force"),
            ("cell_model", "compute_force"))
    for ln, ph, cols_live in zip(lines[1:], seen, live):
        cols = ln.split(";")
        assert cols[1] == "507" and cols[4] == "4" and cols[-1] == "measured"
        assert float(cols[3]) == float(f"{ph['total_step']:g}") > 0
        assert [float(c) for c in cols[5:12]] == [
            float(f"{ph[k]:g}") for k in PHASES]
        _check_reconciles(ph, cols_live)


def test_sweep_repeat_and_dynamic_smoke(tmp_path, capsys):
    """--repeat N: N raw rows for each of the two anchors; --dynamic
    --quick: 8 rows from one set of kernels, the shared stage columns
    and each row's compute_force residual, and one observables row per
    configuration."""
    from sph_sm_monodomain_tpu_torch.tools import sweep
    rep = tmp_path / "rep.csv"
    assert sweep.main(["--repeat", "2", "--scene", SCENE_SMALL, "--steps",
                       "2", "--device", "cpu", "--out", str(rep)]) == 0
    rows = [ln.split(";") for ln in rep.read_text().splitlines()
            if ln and not ln.startswith(("#", "Avg F"))]
    assert [float(r[15]) for r in rows] == [500000.0] * 2 + [800000.0] * 2
    assert "CoV" in capsys.readouterr().out
    dyn = tmp_path / "dyn.csv"
    assert sweep.main(["--dynamic", "--quick", "--scene", SCENE_SMALL,
                       "--steps", "2", "--device", "cpu", "--out",
                       str(dyn)]) == 0
    rows = [ln.split(";") for ln in dyn.read_text().splitlines()
            if ln and not ln.startswith(("#", "Avg F"))]
    assert len(rows) == 8 and {float(r[10]) for r in rows} == {0.8, 0.3}
    # the shared stage columns, the same in every row; each row's compute
    # force is its own step less them (so the columns sum to its step
    # unless the shared head exceeds it)
    shared = {tuple(r[3:8] + r[9:10]) for r in rows}
    assert len(shared) == 1
    head = sum(float(c) for c in shared.pop())
    for r in rows:
        step = float(r[1])
        assert step > 0 and float(r[8]) == pytest.approx(
            max(step - head, 0.0), rel=1e-4, abs=1e-5 * step)
    obs = [ln for ln in (tmp_path / "dyn_obs.csv").read_text().splitlines()
           if ln and not ln.startswith(("#", "K;"))]
    assert len(obs) == 8



def test_profile_ablate_and_footprint_tools(capsys):
    from sph_sm_monodomain_tpu_torch.tools import (ablate_fused,
                                                   hbm_footprint,
                                                   profile_phases)
    ph = profile_phases.main(["--scene", SCENE_SMALL, "--length", "2",
                              "--device", "cpu"])
    assert set(ph) == FUSED_KEYS
    assert "raw pipelines" in capsys.readouterr().out
    ms = ablate_fused.main([SCENE_SMALL, "--device", "cpu", "--steps", "2"])
    assert set(ms) == set(ablate_fused.CONFIGS)
    assert all(np.isfinite(v) and v > 0 for v in ms.values())
    assert set(ablate_fused.main([SCENE_SMALL, "book", "sm", "--device",
                                  "cpu", "--steps", "2"])) == {"book", "sm"}
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            hbm_footprint.main(["--scenes", SCENE_SMALL])
        assert "no CUDA GPU" in str(e.value.code)


# --- the halo pricing tool (after tests/test_aux.py:213-248) ----------------

def _halo_rows(path):
    lines = [ln for ln in open(path) if ln.strip()]
    return ([ln for ln in lines if ln.startswith("#")],
            [ln for ln in lines if not ln.startswith("#")])


def test_halo_gpu_row_is_the_jax_tools_row(tmp_path):
    """append_halo_row writes the JAX tool's header and rows byte for byte
    (only the comment above them differs: it names the tool and the
    backend), and the rows meet tests/test_aux.py's invariants."""
    from sph_sm_monodomain_tpu_torch.tools import halo_gpu
    jtool = _jax_tool("halo_tpu")
    assert halo_gpu.HALO_ROW_HEADER == jtool.HALO_ROW_HEADER
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    rows = (("halo_d1_x7", 129325, 1, 0.0924, 0.0211, 1.70, 20, 18.0),
            ("halo_d1_x56", 1034600, 1, 0.642, 0.1857, 1.70, 10, 60.0))
    for name, mod, backend in (("t.csv", halo_gpu, card),
                               ("j.csv", jtool, card)):
        for r in rows:
            mod.append_halo_row(str(tmp_path / name), *r, backend)
    (t_notes, t_rows), (_, j_rows) = (_halo_rows(tmp_path / n)
                                      for n in ("t.csv", "j.csv"))
    assert t_rows == j_rows
    assert card in t_notes[0] and "halo_gpu.py" in t_notes[0]
    _check_halo_rows(t_rows, jtool.HALO_ROW_HEADER)
    assert all(ln.strip().split(";")[-1] == card for ln in t_rows[1:])
    # the committed rows, measured on the card
    from pathlib import Path
    committed = Path(__file__).resolve().parents[1] / halo_gpu.DEFAULT_ROW
    notes, rows = _halo_rows(committed)
    _check_halo_rows(rows, jtool.HALO_ROW_HEADER)
    assert all(ln.strip().endswith(" W") for ln in rows[1:])


def _check_halo_rows(rows, header):
    """tests/test_aux.py's invariants of a halo pricing file's rows."""
    assert rows[0].strip() == header and len(rows) >= 2
    for ln in rows[1:]:
        c = ln.strip().split(";")
        halo_s, v4_s, ratio = float(c[3]), float(c[4]), float(c[5])
        assert c[0].startswith("halo_d") and int(c[1]) > 0 and int(c[2]) >= 1
        assert halo_s > v4_s > 0
        assert abs(ratio - halo_s / v4_s) < 1e-3 * ratio


def test_halo_gpu_parses_the_jax_tools_arguments():
    from sph_sm_monodomain_tpu_torch.tools.halo_gpu import DEFAULT_ROW, \
        parse_args
    assert parse_args([]) == {"replicate": 7, "length": 20, "check": False,
                              "slack": 1.2, "row": None, "device": "cuda"}
    # a bare --row takes no value: `--row 56` is replicate 56
    got = parse_args(["--row", "56"])
    assert (got["replicate"], got["row"]) == (56, DEFAULT_ROW)
    got = parse_args(["7", "10", "--check", "--slack=1.5", "--row=x.csv",
                      "--device", "cpu"])
    assert got == {"replicate": 7, "length": 10, "check": True,
                   "slack": 1.5, "row": "x.csv", "device": "cpu"}
    assert DEFAULT_ROW == "results_gpu_halo.csv"


def test_halo_gpu_check_at_world_one_on_cpu(monkeypatch, tmp_path):
    """main(["--check", "--device", "cpu", ...]) at world size 1 (gloo) on
    a small two-muscle scene in place of biceps_full xN: every particle
    kept, the 3-step identity-matched check within its limits, the
    timings and the row written."""
    from sph_sm_monodomain_tpu_torch.tools import halo_gpu
    monkeypatch.setattr(halo_gpu, "build_scene",
                        lambda name, replicate=1, device="cuda":
                        T.build_scene("susane", replicate=2, device=device))
    row = tmp_path / "halo.csv"
    out = halo_gpu.main(["2", "2", "--check", "--device", "cpu",
                         f"--row={row}"])
    assert out["particles"] == 2 * T.build_scene(
        "susane", device="cpu").num_particles
    assert set(out["check"]) == set(halo_gpu.CHECK_FIELDS)
    for f, (err, floor, tol) in out["check"].items():
        assert err < tol == max(4.0 * floor, 1e-5), f
    assert out["halo_ms"] > 0 and out["v4_ms"] > 0
    notes, rows = _halo_rows(row)
    assert rows[-1].strip() == out["row"]
    c = out["row"].split(";")
    assert c[0] == "halo_d1_x2" and int(c[1]) == out["particles"]
    assert c[-1] == "cpu" and "on cpu" in notes[0]
