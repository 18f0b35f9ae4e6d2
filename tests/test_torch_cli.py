"""The port's command line (cli.py) against the JAX package.

- RunController on the cases of tests/test_control.py:17-62, and the
  CLI's refusals: an unknown --set key, --devices 2 outside --mode
  coupled, --dynamic-set with --parallel halo (the JAX package's
  refusals), and a run that does not ask for the CPU on a host where
  torch sees no GPU.
- The CLI on the CPU, on susane (507 particles, the smallest named scene)
  for a few steps with --save-checkpoint, in each mode and with --set,
  --corrected-physics, --dynamic-set and --stim-off-step: the saved state
  against the JAX functions that the JAX package's cli.main calls off the
  TPU with the same arguments (run_protocol, simulate_sm_only,
  simulate_sph_only, monodomain_prepare + simulate_monodomain_only), at
  tests/torch_parity.py's tolerances widened by JAX's own 1-ulp spread.
  The JAX functions are called directly: JAX's own CLI test is slow.
- A --traj run whose file the JAX package's reader reads, and a resume:
  a run stopped by its control file, then resumed from its checkpoint,
  ends on the uninterrupted run's bits.
- `--devices 2 --device cpu` (two ranks on gloo) on the unfused all-gather
  and the halo path: the checkpoint against the single-device run, and
  the halo checkpoint resumed on one device; the same command under
  torchrun, which started the ranks.
"""

import threading

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.models import variants as jvar
from sph_sm_monodomain_tpu.runtime import read_trajectory as j_read
from sph_sm_monodomain_tpu.utils.report import REPORT_HEADER as J_REPORT_HEADER
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch import cli
from sph_sm_monodomain_tpu_torch.cli import RunController

from torch_parity import assert_states_close
from torch_parity import ulp_spreads  # noqa: F401 (a fixture)

SCENE, STEPS, CHUNK = "susane", 4, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small ops beside the suite's parallel workers (as in
    tests/test_torch_adjoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- RunController (tests/test_control.py:17-62) ----------------------------

def test_run_controller_file_commands(tmp_path):
    ctl = tmp_path / "ctl"
    saved = {}
    ctl.write_text("stim-off\nsave out.npz\nbogus\n")
    c = RunController(str(ctl),
                      save_fn=lambda p, st, done: saved.update(
                          p=p, st=st, done=done))
    cmd = c(2, "STATE")
    assert cmd.get("stim_off") is True
    # save_fn receives the executed-step count
    assert saved == {"p": "out.npz", "st": "STATE", "done": 2}
    # consumed by OFFSET: a second poll re-reads nothing
    saved.clear()
    assert not c(4, "STATE")
    assert saved == {}
    with open(ctl, "a") as f:               # append like `echo stop >>`
        f.write("stop\n")
    assert c(6, "STATE").get("stop") is True


def test_run_controller_pause_resume(tmp_path):
    ctl = tmp_path / "ctl"
    ctl.write_text("")
    c = RunController(str(ctl), pause_steps=[3], poll_s=0.01)
    t = threading.Timer(0.2, lambda: ctl.write_text("resume\n"))
    t.start()
    cmd = c(3, None)   # blocks until the timer writes 'resume'
    t.join()
    assert not cmd.get("stop")
    assert c.paused is False


# --- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--set", "nope=1"],
    ["--dynamic-set", "cell_size=0.05"],
    ["--devices", "2", "--mode", "sm"],
    ["--devices", "2", "--parallel", "halo", "--dynamic-set",
     "k_stiffness=0.8"],
    ["--mode", "sm", "--stim-off-step", "2"],
], ids=["unknown-set", "static-dynamic-set", "devices", "parallel",
        "stim-off-non-coupled"])
def test_cli_refuses(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(["--scene", SCENE, "--steps", "1", "--device", "cpu"]
                 + argv)
    assert e.value.code not in (0, None)


def test_devices_error_names_the_multi_device_slice(capsys):
    """Multi-device runs are the coupled mode's (as in the JAX package)."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--devices", "2", "--mode", "monodomain"])
    assert "--devices only supports --mode coupled" in str(e.value.code)


def test_cli_without_a_gpu_fails_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        cli.main(["--scene", SCENE, "--steps", "1"])
    assert "--device cpu" in str(e.value.code)


# --- the CLI on the CPU against the JAX functions ----------------------------

def _jax_scene(cfg, stim=True):
    return J.build_scene(SCENE, cfg, stim=stim)


def _jax_coupled(cfg, stim_off, params=None):
    def run(js):
        sc = _jax_scene(cfg)
        return J.run_protocol(sc._replace(state=js), num_steps=STEPS,
                              stim_off_step=stim_off, chunk=CHUNK,
                              params=params)[0]
    return run, _jax_scene(cfg).state


def _jax_sm(cfg):
    def run(js):
        for _ in range(STEPS // CHUNK):
            js = jvar.simulate_sm_only(js, cfg, num_steps=CHUNK)[0]
        return js
    return run, _jax_scene(cfg, stim=False).state


def _jax_sph(cfg):
    cfg = jvar.sph_only_config(cfg)
    sc = _jax_scene(cfg, stim=False)

    def run(js):
        for _ in range(STEPS // CHUNK):
            js = jvar.simulate_sph_only(js, cfg, sc.cell_capacity,
                                        sc.neighbor_capacity,
                                        num_steps=CHUNK, fused=False)[0]
        return js
    return run, sc.state


def _jax_monodomain(cfg, params=None):
    sc = _jax_scene(cfg)

    def run(js):
        tables = jvar.monodomain_prepare(js, cfg, sc.cell_capacity,
                                         sc.neighbor_capacity)
        for _ in range(STEPS // CHUNK):
            js = jvar.simulate_monodomain_only(js, tables, cfg,
                                               num_steps=CHUNK,
                                               params=params)
        return js
    return run, sc.state


CASES = {
    "coupled": ([], lambda: _jax_coupled(J.SimConfig(), STEPS // 2)),
    "coupled-set-stim-off": (
        ["--set", "mu_viscosity=50", "--stim-off-step", "1"],
        lambda: _jax_coupled(J.SimConfig(mu_viscosity=50.0), 1)),
    "coupled-corrected": (
        ["--corrected-physics"],
        lambda: _jax_coupled(J.SimConfig(
            strict_reference_mode=False, quirk_double_self_density=False,
            quirk_pressure_stim_gate=False, quirk_iion_accumulate=False,
            quirk_stim_radius_squared=False), STEPS // 2)),
    "coupled-dynamic": (
        ["--dynamic-set", "k_stiffness=0.8", "--dynamic-set",
         "mu_viscosity=60"],
        lambda: _jax_coupled(J.SimConfig(), STEPS // 2,
                             {"k_stiffness": 0.8, "mu_viscosity": 60.0})),
    "sm": (["--mode", "sm"], lambda: _jax_sm(J.SimConfig())),
    "sph": (["--mode", "sph"], lambda: _jax_sph(J.SimConfig())),
    "monodomain": (["--mode", "monodomain"],
                   lambda: _jax_monodomain(J.SimConfig())),
    "monodomain-dynamic": (
        ["--mode", "monodomain", "--dynamic-set", "fh_c1=0.2"],
        lambda: _jax_monodomain(J.SimConfig(), {"fh_c1": 0.2})),
}


def _cli_run(tmp_path, extra):
    ckpt = tmp_path / "ckpt.npz"
    rc = cli.main(["--scene", SCENE, "--steps", str(STEPS), "--chunk",
                   str(CHUNK), "--device", "cpu", "--save-checkpoint",
                   str(ckpt)] + extra)
    assert rc == 0
    return T.load_checkpoint(str(ckpt), with_config=True, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_the_jax_functions(case, tmp_path, ulp_spreads):
    extra, make = CASES[case]
    ts, step, tcfg = _cli_run(tmp_path, extra)
    assert step == STEPS
    run, js0 = make()
    jst = run(js0)
    spread = ulp_spreads(case, run, js0, ref=jst)
    assert_states_close(ts, jst, np.asarray(jst.active), spread=spread)
    # the checkpoint records the physics that ran, --dynamic-set included
    for flag, kv in zip(extra, extra[1:]):
        if flag == "--dynamic-set":
            k, v = kv.split("=")
            assert getattr(tcfg, k) == float(v)


def test_cli_trajectory_reads_in_jax_and_report_row(tmp_path):
    traj, report = tmp_path / "t.bin", tmp_path / "r.csv"
    rc = cli.main(["--scene", SCENE, "--steps", str(STEPS), "--chunk",
                   str(CHUNK), "--device", "cpu", "--traj", str(traj),
                   "--report", str(report)])
    assert rc == 0
    steps, payload = j_read(traj)
    np.testing.assert_array_equal(steps, [2, 4])   # one frame per chunk
    assert payload.shape == (2, 507, 4) and np.isfinite(payload).all()
    lines = report.read_text().splitlines()
    assert lines[0] == J_REPORT_HEADER and len(lines) == 2
    cols = lines[1].split(";")
    assert len(cols) == 23 and int(cols[2]) == STEPS


def test_cli_resume_ends_on_the_uninterrupted_bits(tmp_path):
    """A coupled run stopped by its control file after the first chunk
    saves its checkpoint at that step; resumed from it, the run ends on
    the bits of the run that was never stopped (stim-off at step 2 maps
    into the remaining window)."""
    full = _cli_run(tmp_path, [])[0]
    ctl, ckpt = tmp_path / "ctl", tmp_path / "half.npz"
    ctl.write_text("stop\n")
    assert cli.main(["--scene", SCENE, "--steps", str(STEPS), "--chunk",
                     str(CHUNK), "--device", "cpu", "--control", str(ctl),
                     "--save-checkpoint", str(ckpt)]) == 0
    assert T.load_checkpoint(str(ckpt), device="cpu")[1] == CHUNK
    out = tmp_path / "end.npz"
    assert cli.main(["--scene", SCENE, "--steps", str(STEPS), "--chunk",
                     str(CHUNK), "--device", "cpu", "--load-checkpoint",
                     str(ckpt), "--save-checkpoint", str(out)]) == 0
    end, step = T.load_checkpoint(str(out), device="cpu")
    assert step == STEPS
    for name in ("pos", "vel", "vm", "dens", "stim"):
        assert torch.equal(getattr(end, name), getattr(full, name)), name


# --- two ranks on gloo (--devices 2 --device cpu) -----------------------------

# tests/test_sharded.py's (unfused, all-gather) and tests/test_halo.py's
# tolerances: the shape-matching sums run in rank order
MULTI_TOLS = {"gather": {"pos": 5e-5, "vel": 5e-4, "vm": 1e-3},
              "halo": {"pos": 2e-5, "vel": 5e-3, "vm": 1e-3, "dens": 1.0}}


def _identity_sorted(st):
    act = st.active.numpy()
    op = st.orig_pos.numpy()[act]
    key = np.lexsort((op[:, 2], op[:, 1], op[:, 0]))
    return {n: getattr(st, n).numpy()[act][key]
            for n in ("pos", "vel", "vm", "dens")}


@pytest.mark.parametrize("parallel", ("gather", "halo"))
def test_cli_two_ranks_match_one_device(parallel, tmp_path, capfd):
    """The CLI's two-rank run against the single-device path it shards:
    the unfused step (what the CLI runs on the CPU) for gather, the fused
    v4 run_protocol for halo; the halo checkpoint is dense and resumes on
    one device."""
    ckpt = tmp_path / "two.npz"
    assert cli.main(["--scene", SCENE, "--steps", str(STEPS), "--chunk",
                     str(CHUNK), "--device", "cpu", "--devices", "2",
                     "--parallel", parallel, "--save-checkpoint",
                     str(ckpt)]) == 0
    out = capfd.readouterr().out
    assert f"parallel impl: {parallel} over 2 devices, transport gloo" in out
    assert "run loop eager (gloo over CPU tensors)" in out
    two, step = T.load_checkpoint(str(ckpt), device="cpu")
    assert step == STEPS and int(two.active.sum()) == 507
    if parallel == "gather":
        one = _cli_run(tmp_path, [])[0]
    else:
        sc = T.build_scene(SCENE, device="cpu")
        one = T.run_protocol(sc, num_steps=STEPS, chunk=CHUNK,
                             fused=True, impl="v4")[0]
    a, b = _identity_sorted(two), _identity_sorted(one)
    for name, tol in MULTI_TOLS[parallel].items():
        np.testing.assert_allclose(a[name], b[name], atol=tol,
                                   err_msg=f"{parallel}: {name}")
    if parallel == "halo":
        end = tmp_path / "end.npz"
        assert cli.main(["--scene", SCENE, "--steps", str(STEPS + CHUNK),
                         "--chunk", str(CHUNK), "--device", "cpu",
                         "--load-checkpoint", str(ckpt),
                         "--save-checkpoint", str(end)]) == 0
        st, step = T.load_checkpoint(str(end), device="cpu")
        assert step == STEPS + CHUNK
        assert torch.isfinite(st.pos[st.active]).all()


def test_cli_under_torchrun_joins_its_ranks(tmp_path):
    """Started by torchrun (RANK / WORLD_SIZE in the environment), the
    command line joins the ranks the launcher started instead of starting
    its own; rank 0 alone prints and writes the checkpoint."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    ckpt = tmp_path / "torchrun.npz"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "sph_sm_monodomain_tpu_torch",
         "--scene", SCENE, "--steps", str(CHUNK), "--chunk", "1",
         "--devices", "2", "--device", "cpu", "--parallel", "halo",
         "--save-checkpoint", str(ckpt)],
        capture_output=True, text=True, timeout=300, cwd=str(root),
        env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("parallel impl: halo over 2 devices, "
                            "transport gloo") == 1
    st, step = T.load_checkpoint(str(ckpt), device="cpu")
    assert step == CHUNK and int(st.active.sum()) == 507
