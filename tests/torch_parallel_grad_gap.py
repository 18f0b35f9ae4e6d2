"""The multi-device gradient of the all-gather path against one device:
d(loss)/dK through the differentiable collectives
(sph_sm_monodomain_tpu_torch.parallel.comm: all_gather's VJP a
reduce-scatter, all_sum's an all_sum), and the `replicated` contract.

Two ranks on gloo over CPU tensors run the all-gather path for 2 steps,
with k_stiffness an override that requires grad; each rank
differentiates its rows' share of the loss sum(pos * w) (w seeded):
  - through the step body in a plain loop (torch_parallel_ranks.step_loop
    over sharded_step._sharded_step_body, the override NOT passed through
    comm.replicated): each rank's gradient is its share's part of
    d(loss)/dK, and their sum over the ranks is the whole;
  - through make_sharded_simulate (the checkpointed adjoint scan, the
    override passed through comm.replicated once a call): each rank's
    gradient is already the whole d(loss)/dK, the sum over the ranks of
    the parts above.
One device runs the same steps (models.monodomain.simulate, unfused, the
adjoint scan) and a central difference. Before the collectives had VJPs
the two ranks' summed gradient read 0.0441842 against one device's
0.0820182. Imports torch and the port only:

    PYTHONPATH=.:tests python tests/torch_parallel_grad_gap.py
"""

import numpy as np
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.parallel import comm as C
from sph_sm_monodomain_tpu_torch.parallel import sharded_step as S

import torch_parallel_ranks as R

STEPS, K0, H = 2, 0.8, 1e-3


def weights(cap: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(5).normal(
        size=(cap, 3)).astype(np.float32))


def rank_main(comm):
    torch.set_num_threads(1)
    st = R.blob_state()
    n_loc = st.capacity // comm.size
    w = weights(st.capacity)[comm.rank * n_loc:(comm.rank + 1) * n_loc]
    k = torch.tensor(K0, requires_grad=True)
    out, _ = R.step_loop(
        lambda s, inv, prm: S._sharded_step_body(s, R.CFG, R.NBR, comm,
                                                 sm_inv=inv, params=prm),
        S.shard_state(st, comm), R.CFG, STEPS, -1, comm,
        {"k_stiffness": k})
    share = (out.pos * w).sum()
    part = torch.autograd.grad(share, k)[0]
    k = torch.tensor(K0, requires_grad=True)
    out, _ = S.make_sharded_simulate(comm, R.CFG, R.NBR, STEPS)(
        S.shard_state(st, comm), {"k_stiffness": k})
    whole = torch.autograd.grad((out.pos * w).sum(), k)[0]
    with torch.no_grad():
        loss = comm.all_sum(share.detach().double())
        parts = comm.all_gather(part.detach().double()[None])
        wholes = comm.all_gather(whole.detach().double()[None])
    if comm.rank == 0:
        print(f"{comm.size} ranks (gloo): loss {float(loss):.9g}; the step "
              "bodies, the override not replicated: each rank's part "
              f"{parts.tolist()}, summed over the ranks "
              f"{float(parts.sum()):.9g}; make_sharded_simulate, the "
              f"override replicated: each rank's {wholes.tolist()}",
              flush=True)


def one_device(k):
    st = R.blob_state()
    out, _ = T.simulate(st, R.CFG, num_steps=STEPS, fused=False,
                        neighbor_capacity=R.NBR, params={"k_stiffness": k})
    return (out.pos.double() * weights(st.capacity).double()).sum()


if __name__ == "__main__":
    torch.set_num_threads(1)
    k = torch.tensor(K0, requires_grad=True)
    loss = one_device(k)
    g = torch.autograd.grad(loss, k)[0]
    with torch.no_grad():
        fd = (one_device(torch.tensor(K0 + H))
              - one_device(torch.tensor(K0 - H))) / (2 * H)
    print(f"one device: loss {float(loss.detach()):.9g}, dloss/dK "
          f"{float(g):.9g}, "
          f"central difference (h {H}) {float(fd):.9g}", flush=True)
    C.spawn(rank_main, 2, (), device_type="cpu")
