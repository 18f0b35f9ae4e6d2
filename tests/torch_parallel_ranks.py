"""The multi-device cases of tests/test_torch_parallel.py, run by the ranks
that test spawns (gloo over CPU tensors), and the inputs they share with
the test process. Imports numpy, torch and the port only: the ranks never
import jax nor the JAX package.

`run_world(comm, out_dir)` runs every case on this rank, each from inputs
made here with numpy from fixed seeds, and rank 0 writes the gathered
results to out_dir/world<D>.npz; each rank also writes the modules it has
imported to out_dir/modules<rank>.txt.

    python tests/torch_parallel_ranks.py D OUT_DIR

spawns D ranks of run_world (the test starts it in the background).
"""

from __future__ import annotations

import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.parallel import comm as C
from sph_sm_monodomain_tpu_torch.parallel import halo_step as H
from sph_sm_monodomain_tpu_torch.parallel import sharded_step as S
from sph_sm_monodomain_tpu_torch.state import FIELD_NAMES

CFG = T.SimConfig()
NBR = 9 * 64             # unfused table width (tests/test_sharded.py)
FUSED_SUB_Q = 32         # capacity 512 = 4 ranks x 4 sub-blocks of 32 rows
HALO_SUB_Q = 64          # the JAX halo tests' sub_q
GATHER_STEPS, FUSED_STEPS, HALO_STEPS, MIGRATION_STEPS = 3, 2, 3, 8
# physics overrides of the dynamic-params cases (tests/test_halo.py)
OVERRIDES = {"k_stiffness": 0.8, "mu_viscosity": 150.0, "sm_alpha": 0.5,
             "fh_c1": 0.2}
# a world of 750^3 cells: window ids pass 2^24, where a value cast of the
# id column through float32 would merge neighbouring ids
BIG_WORLD = (30.0, 30.0, 30.0)
# the run-loop cases: steps, the stim-off index, the steps of the first of
# two chunks (the stim-off falls in the second, shifted); a table of 2
# slots a run (the gather path's overflow) and a boundary capacity of 8
# rows (the halo path's)
LOOP_STEPS, LOOP_STIM_OFF, LOOP_SPLIT = 5, 3, 2
LOOP_NBR, LOOP_HALO_CAP = 18, 8
LOOP_PATHS = ("sharded_gather", "sharded_fused", "halo")
# the multi-device makers, in the order of the refusal case; the four
# of the fused slab and halo paths refuse autograd
GRAD_MAKERS = ("make_sharded_step", "make_sharded_step_fused",
               "make_halo_step", "make_sharded_simulate",
               "make_sharded_simulate_fused", "make_halo_simulate")
REFUSING = ("make_sharded_step_fused", "make_halo_step",
            "make_sharded_simulate_fused", "make_halo_simulate")
# the all-gather path's value-and-grad: steps, stim-off index and the
# overrides that require grad of the simulate case; steps of the step
# case; the initial fields that require grad (orig_pos: the hoisted
# rest-shape invariants' path); the state (at D = 4 the last rank holds
# rows 384-511, all padding)
GRAD_STEPS, GRAD_STIM_OFF, GRAD_STEP_STEPS = 3, 1, 2
GRAD_PARAMS = ("k_stiffness", "mu_viscosity")
GRAD_FIELDS = ("vel", "vm", "orig_pos")
# rows of each rank's input to the collectives' VJP case
VJP_ROWS = 3


def blob_state(n=300, n_fixed=7, pad_to=None, seed=0):
    """tests/test_sharded.py's state: a Gaussian blob, stimulated in a
    sphere, its first rows fixed."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(size=(n, 3)).astype(np.float32) * 0.06 + 0.6,
                  0.05, 1.2)
    st = T.init_fluid(pts, CFG, pad_to=pad_to, device="cpu")
    st = T.stim.set_stim(st, (0.6, 0.6, 0.6), 0.5, CFG.stim_strength, CFG)
    fixed = torch.zeros(st.capacity, dtype=torch.bool)
    fixed[:n_fixed] = True
    return st.replace(fixed=fixed)


def clustered_gather_state(seed=2):
    """tests/test_sharded.py's two-muscle state (sm_clusters = 2)."""
    cfg = CFG.replace(world_size=(3.0, 1.5, 1.5), sm_clusters=2)
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(size=(144, 3)).astype(np.float32) * 0.06
                  + 0.6, 0.05, 1.2)
    both = np.concatenate([pts, pts + [1.5, 0, 0]]).astype(np.float32)
    st = T.init_fluid(both, cfg, pad_to=512, device="cpu")
    st = T.stim.set_stim(st, (0.6, 0.6, 0.6), 0.5, cfg.stim_strength, cfg)
    st = T.stim.set_stim(st, (2.1, 0.6, 0.6), 0.5, cfg.stim_strength, cfg)
    return cfg, st


def halo_cases() -> dict:
    """{name: (cfg, state, steps)} of the halo cases (tests/test_halo.py's
    clouds): uniform, one occupied slab (empty ranks), an x-stretched
    world, two muscles, a world whose ids pass 2^24."""
    out = {}
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.06, 1.44, size=(900, 3)).astype(np.float32)
    st = T.init_fluid(pts, CFG, device="cpu")
    out["uniform"] = (CFG, T.stim.turn_on_stim_mesh(st, pts, CFG),
                      HALO_STEPS)

    rng = np.random.default_rng(4)
    pts = rng.uniform(0.05, 0.15, size=(400, 3)).astype(np.float32)
    pts[:, :2] = rng.uniform(0.4, 1.1, size=(400, 2)).astype(np.float32)
    st = T.init_fluid(pts, CFG, device="cpu")
    out["empty"] = (CFG, T.stim.turn_on_stim_mesh(st, pts, CFG), HALO_STEPS)

    cfg = CFG.replace(world_size=(6.0, 1.5, 1.5))
    rng = np.random.default_rng(5)
    pts = rng.uniform(0.06, 1.44, size=(700, 3)).astype(np.float32)
    pts[:, 0] = rng.uniform(0.06, 5.9, size=700).astype(np.float32)
    st = T.init_fluid(pts, cfg, device="cpu")
    out["stretched"] = (cfg, T.stim.turn_on_stim_mesh(st, pts, cfg),
                        HALO_STEPS)

    cfg = CFG.replace(world_size=(3.0, 1.5, 1.5), sm_clusters=2)
    rng = np.random.default_rng(6)
    pts = rng.uniform(0.06, 1.44, size=(260, 3)).astype(np.float32)
    both = np.concatenate([pts, pts + [1.5, 0, 0]]).astype(np.float32)
    st = T.init_fluid(both, cfg, device="cpu")
    out["clustered"] = (cfg, T.stim.turn_on_stim_mesh(st, both, cfg,
                                                      tile_width=1.5),
                        HALO_STEPS)

    cfg = CFG.replace(world_size=BIG_WORLD)
    rng = np.random.default_rng(7)
    pts = (rng.uniform(-0.5, 0.5, size=(1500, 3)) * [0.3, 0.3, 0.5]
           + 15.0).astype(np.float32)
    st = T.init_fluid(pts, cfg, device="cpu")
    out["big_world"] = (cfg, T.stim.turn_on_stim_mesh(st, pts, cfg),
                        HALO_STEPS)
    return out


def migration_state():
    """tests/test_halo.py's migration cloud: every particle given a
    z-velocity that carries it ~0.6 cells in 8 steps."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(0.06, 1.3, size=(600, 3)).astype(np.float32)
    vel = np.zeros_like(pts)
    vel[:, 2] = 2.5
    return T.init_fluid(pts, CFG, velocities=vel, device="cpu")


def _fields(st, names=("pos", "vel", "vm", "dens", "iion", "w", "goal_pos",
                       "pres", "inter_vm", "stim", "active", "orig_pos")):
    return {n: getattr(st, n).numpy() for n in names}


def _put(res, prefix, arrays):
    for k, v in arrays.items():
        res[f"{prefix}/{k}"] = np.asarray(v)


def _comm_case(comm, res):
    d, r = comm.size, comm.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * r
    ids = torch.tensor([r, (1 << 24) + 2 * r + 1], dtype=torch.int32)
    per_rank = torch.cat([
        torch.tensor([float(comm.axis_index())]),
        comm.shift(x, +1).reshape(-1), comm.shift(x, -1).reshape(-1)])
    _put(res, f"comm{d}", {
        "all_gather": comm.all_gather(x),
        "all_sum": comm.all_sum(x),
        "all_sum_f64": comm.all_sum(x.to(torch.float64) / 3.0),
        "per_rank": comm.all_gather(per_rank[None, :]),
        "shift_ids": comm.all_gather(comm.shift(ids.view(torch.float32), +1)
                                     .view(torch.int32)[None, :])})


def _gather_cases(comm, res):
    st = S.shard_state(blob_state(), comm)
    step = S.make_sharded_step(comm, CFG, NBR)
    ovf = []
    for _ in range(GATHER_STEPS):
        st, o = step(st)
        ovf.append(int(o))
    _put(res, "gather", {**_fields(S.gather_state(st, comm)),
                         "overflow": ovf})

    cfg, st = clustered_gather_state()
    st = S.shard_state(st, comm)
    step = S.make_sharded_step(comm, cfg, NBR)
    for _ in range(GATHER_STEPS):
        st, _ = step(st)
    _put(res, "gather_clustered", _fields(S.gather_state(st, comm)))

    sim = S.make_sharded_simulate(comm, CFG, NBR, num_steps=4,
                                  stim_off_step=2)
    st, o = sim(S.shard_state(blob_state(200, seed=9), comm),
                {k: torch.tensor(v) for k, v in OVERRIDES.items()})
    _put(res, "gather_sim", {**_fields(S.gather_state(st, comm)),
                             "overflow": int(o)})


def _fused_cases(comm, res):
    st = S.shard_state(blob_state(400, 5, pad_to=512, seed=1), comm)
    step = S.make_sharded_step_fused(comm, CFG, sub_q=FUSED_SUB_Q)
    for _ in range(FUSED_STEPS):
        st, _ = step(st)
    _put(res, "fused", _fields(S.gather_state(st, comm)))

    sim = S.make_sharded_simulate_fused(comm, CFG, num_steps=3,
                                        stim_off_step=1, sub_q=FUSED_SUB_Q)
    st, o = sim(S.shard_state(blob_state(300, 0, pad_to=512, seed=10),
                              comm),
                {k: torch.tensor(v) for k, v in OVERRIDES.items()})
    _put(res, "fused_sim", {**_fields(S.gather_state(st, comm)),
                            "overflow": int(o)})


def window_misses(qm, feats, lo, hi, cfg, sub_q):
    """Pairs of query rows qm (N_q, 16) and candidates feats (16, N_c) that
    the exact v4 cell mask accepts but that lie outside the query's
    sub-block windows (lo / hi, 4 a sub-block): the pairs a kernel would
    miss. The plain sweeps read no windows, so this holds them on the
    CPU."""
    from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
    mask = fst._window_mask(cfg, "xyz3", False)
    idx = torch.arange(feats.shape[1])
    misses = 0
    for b in range(qm.shape[0] // sub_q):
        inside = torch.zeros_like(idx, dtype=torch.bool)
        for r in range(3):
            inside |= (idx >= lo[4 * b + r]) & (idx < hi[4 * b + r])
        m = mask(qm[b * sub_q:(b + 1) * sub_q], feats)
        misses += int((m & ~inside[None, :]).sum())
    return misses


def _halo_cases(comm, res):
    for name, (cfg, st0, steps) in halo_cases().items():
        st, s_cap, mig, halo = H.shard_state_halo(st0, comm, cfg)
        step = H.make_halo_step(comm, cfg, mig, halo, sub_q=HALO_SUB_Q)
        misses = []
        real = H.sweep_a3

        def checked(qm, feats, lo, hi, cfg_, **kw):
            misses.append(window_misses(qm, feats, lo, hi, cfg_,
                                        kw["sub_q"]))
            return real(qm, feats, lo, hi, cfg_, **kw)
        ovf = []
        with mock.patch.object(H, "sweep_a3", checked):
            for _ in range(steps):
                st, o = step(st)
                ovf.append(int(o))
        missed = comm.all_sum(torch.tensor(misses, dtype=torch.int64))
        _put(res, f"halo_{name}", {**_fields(S.gather_state(st, comm)),
                                   "overflow": ovf, "s_cap": s_cap,
                                   "window_misses": missed})

    st0 = migration_state()
    st, s_cap, mig, halo = H.shard_state_halo(st0, comm, CFG)
    sim = H.make_halo_simulate(comm, CFG, mig, halo, MIGRATION_STEPS,
                               sub_q=HALO_SUB_Q)
    st, o = sim(st)
    _put(res, "halo_migration", {**_fields(S.gather_state(st, comm)),
                                 "overflow": int(o), "s_cap": s_cap})

    _, st0, _ = halo_cases()["uniform"]
    st, s_cap, mig, halo = H.shard_state_halo(st0, comm, CFG)
    dyn = H.make_halo_step(comm, CFG, mig, halo, sub_q=HALO_SUB_Q)
    baked = H.make_halo_step(comm, CFG.replace(**OVERRIDES), mig, halo,
                             sub_q=HALO_SUB_Q)
    params = {k: torch.tensor(v) for k, v in OVERRIDES.items()}
    a, b = st, st
    for _ in range(HALO_STEPS):
        a, _ = dyn(a, params)
        b, _ = baked(b)
    _put(res, "halo_dyn", _fields(S.gather_state(a, comm)))
    _put(res, "halo_baked", _fields(S.gather_state(b, comm)))


def step_loop(body, state, cfg, num_steps, stim_off_step, mesh,
              params=None):
    """The loop the multi-device simulates ran before models/scan: eager
    steps of body(state, sm_inv, params) -> (state, overflow) with the
    rest-shape moments hoisted, turnOffStim before step `stim_off_step`,
    the largest per-step overflow. The reference the simulates are held
    to bit for bit. It steps the bodies the single-step makers step: the
    makers recompute the moments each step, and after the halo path's
    migration reorders the rows their sums differ in the last bits."""
    from sph_sm_monodomain_tpu_torch.ops.shape_matching import sm_invariants
    sm_inv = sm_invariants(state, cfg, comm=mesh)
    overflow = torch.zeros((), dtype=torch.int32)
    for i in range(num_steps):
        if i == stim_off_step:
            state = T.stim.turn_off_stim(state, cfg)
        state, o = body(state, sm_inv, params)
        overflow = torch.maximum(overflow, o)
    return state, overflow


def loop_paths(comm) -> dict:
    """{path: (make(num_steps, stim_off_step) -> simulate, body(state,
    sm_inv, params), cfg, sharded state)} of the run-loop cases; the
    gather and halo paths at capacities that overflow."""
    halo_st, _, mig, _ = H.shard_state_halo(halo_cases()["uniform"][1],
                                            comm, CFG)
    return {
        "sharded_gather": (
            lambda n, off: S.make_sharded_simulate(comm, CFG, LOOP_NBR, n,
                                                   off),
            lambda st, inv, prm: S._sharded_step_body(
                st, CFG, LOOP_NBR, comm, sm_inv=inv, params=prm),
            CFG, S.shard_state(blob_state(200, seed=9), comm)),
        "sharded_fused": (
            lambda n, off: S.make_sharded_simulate_fused(
                comm, CFG, n, off, sub_q=FUSED_SUB_Q),
            lambda st, inv, prm: S._sharded_fused_body(
                st, CFG, FUSED_SUB_Q, comm, sm_inv=inv, params=prm),
            CFG, S.shard_state(blob_state(300, 0, pad_to=512, seed=10),
                               comm)),
        "halo": (
            lambda n, off: H.make_halo_simulate(
                comm, CFG, mig, LOOP_HALO_CAP, n, off, sub_q=HALO_SUB_Q),
            lambda st, inv, prm: H._halo_body(
                st, CFG, HALO_SUB_Q, mig, LOOP_HALO_CAP, comm, inv, prm),
            CFG, halo_st)}


def _bit_mismatches(a, b) -> int:
    """Fields of two states whose bits differ."""
    bad = 0
    for f in FIELD_NAMES:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        bad += int(not torch.equal(x, y))
    return bad


def _loop_cases(comm, res):
    """Each simulate (through models/scan.run_steps) against the step loop
    it replaced, with the stim-off inside the run and physics overrides,
    and a run in two chunks (the stim-off index shifted into the second)
    against the same two chunks of the loop and against the one run. Bit
    mismatches summed over the ranks (one run vs loop, two chunks vs
    loop, two chunks vs one run), the largest |pos| difference of the two
    chunks from the one run, the overflows, and the capture keys each
    rank passed."""
    params = {k: torch.tensor(v) for k, v in OVERRIDES.items()}
    keys = []
    real = S.run_steps

    def recording(step, state, num_steps, *, key, **kw):
        keys.append(repr(key))
        return real(step, state, num_steps, key=key, **kw)
    off2 = LOOP_STIM_OFF - LOOP_SPLIT
    for path, (make, body, cfg, st) in loop_paths(comm).items():
        with mock.patch.object(S, "run_steps", recording):
            one, o1 = make(LOOP_STEPS, LOOP_STIM_OFF)(st, params)
            a, oa = make(LOOP_SPLIT, -1)(st, params)
            two, ob = make(LOOP_STEPS - LOOP_SPLIT, off2)(a, params)
        ref, o_ref = step_loop(body, st, cfg, LOOP_STEPS, LOOP_STIM_OFF,
                               comm, params)
        ref_a, _ = step_loop(body, st, cfg, LOOP_SPLIT, -1, comm, params)
        ref_two, _ = step_loop(body, ref_a, cfg, LOOP_STEPS - LOOP_SPLIT,
                               off2, comm, params)
        mism = comm.all_sum(torch.tensor(
            [_bit_mismatches(one, ref), _bit_mismatches(two, ref_two),
             _bit_mismatches(two, one)]))
        full, full_two = (S.gather_state(x, comm) for x in (one, two))
        _put(res, f"loop_{path}", {
            "mismatch": mism,
            "chunk_pos_err": float((full_two.pos - full.pos).abs().max()),
            "overflow": [int(o1), int(o_ref), max(int(oa), int(ob))],
            "stim": full.stim.numpy(), "active": full.active.numpy(),
            "pos": full.pos.numpy()})
    every = [None] * comm.size
    dist.all_gather_object(every, keys)
    res["loop_keys"] = np.asarray(every)


def grad_state():
    """The state of the all-gather path's value-and-grad cases: 300
    particles padded to 512 rows (at D = 4 the last rank's rows are all
    padding)."""
    return blob_state(300, 0, pad_to=512, seed=10)


def grad_weights(cap: int) -> torch.Tensor:
    """The seeded weights w of the loss sum(pos * w)."""
    return torch.from_numpy(np.random.default_rng(5).normal(
        size=(cap, 3)).astype(np.float32))


def grad_inputs(st, fields=GRAD_FIELDS):
    """(state with `fields` requiring grad, their tensors, the overrides
    GRAD_PARAMS requiring grad)."""
    leaves = {f: getattr(st, f).detach().clone().requires_grad_()
              for f in fields}
    params = {k: torch.tensor(OVERRIDES[k], requires_grad=True)
              for k in GRAD_PARAMS}
    return st.replace(**leaves), leaves, params


def _sharded_value_and_grad(comm, run, st0, w):
    """This rank's share of loss = sum(pos * w) over its rows after
    run(state, params), and torch.autograd.grad of that share w.r.t. the
    overrides and the initial fields. Returns (loss summed over the ranks
    in float64, the overrides' gradients on this rank, the fields'
    gradients gathered in rank order, the largest overflow)."""
    n_loc = st0.capacity // comm.size
    w_loc = w[comm.rank * n_loc:(comm.rank + 1) * n_loc]
    st, leaves, params = grad_inputs(S.shard_state(st0, comm))
    out, ovf = run(st, params)
    share = (out.pos * w_loc).sum()
    grads = torch.autograd.grad(share, list(params.values())
                                + list(leaves.values()))
    with torch.no_grad():
        value = comm.all_sum(share.detach().double())
        fields = {f: comm.all_gather(g) for f, g in
                  zip(leaves, grads[len(params):])}
    return value, torch.stack(grads[:len(params)]), fields, int(ovf)


def _vjp_cases(comm, res):
    """Each collective's VJP in float64 on both gloo transports (gloo
    through host copies runs on CPU tensors here too): rank r's input x_r
    ((VJP_ROWS, 2), seeded by r) and cotangent c_r (seeded by r); the
    largest |autograd's gradient - the formula| on any rank, where the
    formula is sum_r' c_r'[r n:(r + 1) n] (all_gather), sum_r' c_r'
    (all_sum, replicated)."""
    d, r = comm.size, comm.rank

    def seeded(k, rows):
        return torch.from_numpy(np.random.default_rng(100 * k + rows)
                                .normal(size=(rows, 2)))
    n = VJP_ROWS
    cots_g = [seeded(k, d * n) for k in range(d)]
    cots_s = [seeded(k, n) for k in range(d)]
    want = {"all_gather": sum(c[r * n:(r + 1) * n] for c in cots_g),
            "all_sum": sum(cots_s), "replicated": sum(cots_s)}
    for transport in ("gloo", "gloo-host"):
        cm = C.Comm(r, d, transport, "cpu")
        errs = []
        for name, cot in (("all_gather", cots_g[r]), ("all_sum", cots_s[r]),
                          ("replicated", cots_s[r])):
            x = seeded(50 + r, n).requires_grad_()
            y = getattr(cm, name)(x)
            (g,) = torch.autograd.grad(y, x, cot)
            errs.append(float((g - want[name]).abs().max())
                        + float(g.dtype != torch.float64))
        res[f"vjp/{transport}"] = comm.all_gather(
            torch.tensor([errs], dtype=torch.float64)).numpy()


def _grad_cases(comm, res):
    """The all-gather path under autograd, then the refusal of the fused
    slab and halo paths.

    grad_sim: make_sharded_simulate (GRAD_STEPS steps, stim off before
    GRAD_STIM_OFF) on grad_state, the overrides GRAD_PARAMS and the
    fields GRAD_FIELDS requiring grad: the loss, every rank's override
    gradients, the fields' gradients, the overflow, the last rank's
    active rows. grad_host: the same run through a Comm of the gloo-host
    transport (its run loop scan.run_steps_uncaptured): fields of
    (value, gradients) whose bits differ from grad_sim's, summed over the
    ranks. grad_step: make_sharded_step, GRAD_STEP_STEPS steps under eager
    autograd, the same loss and inputs.

    grad_raised: every multi-device maker called with an override that
    requires grad, then with a state whose positions require grad: 1
    where it raised naming the missing VJPs and the JAX package, before
    any collective (so every rank raises alike), 0 where it ran; then the
    fused step once under torch.no_grad(), where it runs."""
    st0, w = grad_state(), grad_weights(512)
    _vjp_cases(comm, res)

    def sim_on(cm):
        return S.make_sharded_simulate(cm, CFG, NBR, GRAD_STEPS,
                                       GRAD_STIM_OFF)
    value, pgrad, fgrad, ovf = _sharded_value_and_grad(
        comm, sim_on(comm), st0, w)
    n_loc = st0.capacity // comm.size
    _put(res, "grad_sim", {
        "value": value, "params": comm.all_gather(pgrad[None, :]),
        **fgrad, "overflow": ovf,
        "last_rank_active": int(st0.active[-n_loc:].sum())})
    host = C.Comm(comm.rank, comm.size, "gloo-host", "cpu")
    hv, hp, hf, _ = _sharded_value_and_grad(host, sim_on(host), st0, w)
    bits = int(not torch.equal(hv, value)) + int(not torch.equal(hp, pgrad))
    bits += sum(int(not torch.equal(hf[f], fgrad[f])) for f in fgrad)
    res["grad_host/mismatch"] = np.asarray(int(comm.all_sum(
        torch.tensor(bits))))
    res["grad_host/run_loop"] = np.asarray(S.run_loop(host)[1])

    step = S.make_sharded_step(comm, CFG, NBR)

    def steps(st, params):
        ovf = 0
        for _ in range(GRAD_STEP_STEPS):
            st, o = step(st, params)
            ovf = max(ovf, int(o))
        return st, ovf
    value, pgrad, fgrad, ovf = _sharded_value_and_grad(comm, steps, st0, w)
    _put(res, "grad_step", {
        "value": value, "params": comm.all_gather(pgrad[None, :]),
        **fgrad, "overflow": ovf})

    st = S.shard_state(blob_state(300, 0, pad_to=512, seed=10), comm)
    halo_st, _, mig, halo = H.shard_state_halo(
        halo_cases()["uniform"][1], comm, CFG)
    makers = {
        "make_sharded_step": (lambda: S.make_sharded_step(comm, CFG, NBR),
                              st),
        "make_sharded_step_fused": (lambda: S.make_sharded_step_fused(
            comm, CFG, sub_q=FUSED_SUB_Q), st),
        "make_halo_step": (lambda: H.make_halo_step(
            comm, CFG, mig, halo, sub_q=HALO_SUB_Q), halo_st),
        "make_sharded_simulate": (lambda: S.make_sharded_simulate(
            comm, CFG, NBR, 2), st),
        "make_sharded_simulate_fused": (lambda: S.make_sharded_simulate_fused(
            comm, CFG, 2, sub_q=FUSED_SUB_Q), st),
        "make_halo_simulate": (lambda: H.make_halo_simulate(
            comm, CFG, mig, halo, 2, sub_q=HALO_SUB_Q), halo_st)}
    raised = np.zeros((len(GRAD_MAKERS), 2), np.int32)
    for i, name in enumerate(GRAD_MAKERS):
        make, s0 = makers[name]
        k = torch.tensor(OVERRIDES["k_stiffness"], requires_grad=True)
        calls = (lambda: make()(s0, {"k_stiffness": k}),
                 lambda: make()(s0.replace(
                     pos=s0.pos.clone().requires_grad_())))
        for j, call in enumerate(calls):
            try:
                call()
            except RuntimeError as e:
                raised[i, j] = int("no VJP" in str(e)
                                   and "JAX package" in str(e))
    k = torch.tensor(OVERRIDES["k_stiffness"], requires_grad=True)
    with torch.no_grad():
        out, _ = makers["make_sharded_step_fused"][0]()(
            st, {"k_stiffness": k})
    res["grad_raised"] = raised
    res["grad_no_grad_ran"] = np.asarray(
        int(torch.isfinite(out.pos).all() and not out.pos.requires_grad))


def run_world(comm, out_dir):
    """Every case on this rank; rank 0 writes world<D>.npz."""
    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    (out_dir / f"modules{comm.rank}.txt").write_text(
        "\n".join(sorted(sys.modules)))
    res = {}
    _comm_case(comm, res)
    _gather_cases(comm, res)
    _fused_cases(comm, res)
    _halo_cases(comm, res)
    _loop_cases(comm, res)
    _grad_cases(comm, res)
    if comm.rank == 0:
        np.savez(out_dir / f"world{comm.size}.npz", **res)


def run_card(comm, out_dir):
    """The fused slab and halo paths on the rank's card (ranks sharing one
    card talk gloo through host copies): rank 0 writes card<D>.npz with
    the gathered results and the slab launches of K1 / K2 on each rank."""
    from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
    dev, res = comm.device, {}
    fst.sweep_a3.slab_launches = fst.sweep_b3.slab_launches = 0
    st = S.shard_state(blob_state(400, 5, pad_to=512, seed=1).to(dev), comm)
    step = S.make_sharded_step_fused(comm, CFG, sub_q=FUSED_SUB_Q)
    for _ in range(FUSED_STEPS):
        st, _ = step(st)
    _put(res, "fused", {k: v for k, v in _fields(
        S.gather_state(st, comm).to("cpu")).items()})
    cfg, st0, steps = halo_cases()["uniform"]
    st, _, mig, halo = H.shard_state_halo(st0.to(dev), comm, cfg)
    step = H.make_halo_step(comm, cfg, mig, halo, sub_q=HALO_SUB_Q)
    ovf = []
    for _ in range(steps):
        st, o = step(st)
        ovf.append(int(o))
    _put(res, "halo", {**_fields(S.gather_state(st, comm).to("cpu")),
                       "overflow": ovf})
    launches = comm.all_gather(torch.tensor(
        [[fst.sweep_a3.slab_launches, fst.sweep_b3.slab_launches,
          fst.sweep_a3.launches, fst.sweep_b3.launches]],
        dtype=torch.int32, device=dev))
    res["launches"] = launches.cpu().numpy()
    res["transport"] = np.asarray(comm.transport)
    if comm.rank == 0:
        np.savez(Path(out_dir) / f"card{comm.size}.npz", **res)


if __name__ == "__main__":
    C.spawn(run_world, int(sys.argv[1]), (sys.argv[2],), device_type="cpu")
