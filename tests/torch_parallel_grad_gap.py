"""What the multi-device collectives' missing VJPs cost a gradient, and why
every multi-device step and simulate raises under autograd
(sph_sm_monodomain_tpu_torch.parallel.comm.refuse_grad).

Two ranks on gloo over CPU tensors run the all-gather path's step body
(sharded_step._sharded_step_body, which the step and simulate makers
wrap) for 2 steps in the step loop the simulates ran before
models/scan (torch_parallel_ranks.step_loop), with k_stiffness an override
that requires grad; each rank differentiates its rows' share of the loss
sum(pos * w) (w seeded), and the ranks' gradients are summed. One device
runs the same steps (models.monodomain.simulate, unfused, the adjoint
scan) and a central difference. Imports torch and the port only:

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
    loss = (out.pos * w).sum()
    g = torch.autograd.grad(loss, k)[0]
    tot = comm.all_sum(torch.stack([loss.detach().double(),
                                    g.detach().double()]))
    if comm.rank == 0:
        print(f"{comm.size} ranks (gloo): loss {float(tot[0]):.9g}, "
              f"dloss/dK summed over the ranks {float(tot[1]):.9g}",
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
