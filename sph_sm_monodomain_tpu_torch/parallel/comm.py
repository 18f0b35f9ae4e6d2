"""Collectives over the port's 1-D group of ranks: the counterpart of
`jax.lax`'s collectives over the JAX package's mesh axis "p"
(`axis_index`, `all_gather(..., tiled=True)`, `psum`, and the one-slab
`ppermute` of `parallel/halo_step._shift`), on `torch.distributed` with one
process per rank.

Transports, picked from the rank count and the cards torch sees, printed
by the callers, and never switched after a failure:
  "gloo"       CPU tensors (the tests, `--device cpu`);
  "nccl"       CUDA tensors, one card a rank;
  "gloo-host"  CUDA tensors of ranks that share a card (NCCL refuses two
               ranks on one GPU): every collective copies its tensor to
               host memory, runs gloo on the host copy, and copies the
               result back to the rank's card.

`all_gather` and `all_sum` are differentiable on every transport (the
transpose rules `shard_map` applies to `all_gather` and `psum`): the VJP
of all_gather gives rank r the sum over the ranks of their cotangents'
rows [r n, (r + 1) n) (a reduce-scatter), the VJP of all_sum is an all_sum
of the cotangent. `replicated(x)` is the identity whose VJP all_sums the
cotangent: a replicated operand (the physics overrides) passes through it
once a call, so that each rank's gradient of its own rows' share of a
loss is the gradient of the loss summed over the ranks, what `jax.grad`
of a loss over the gathered output of a `shard_map` gives for a `P()`
input. Integer tensors stay outside autograd, and `shift` has no VJP: the
halo path that uses it refuses autograd (`refuse_grad`), as the JAX
package's does not differentiate it either.

`spawn(fn, world)` starts `world` ranks of `fn(comm, *args)` on this host
(the command line's `--devices N`); `init_from_env` joins the ranks a
launcher such as `torchrun` started. Nothing here runs at import time.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from ..models import scan
from ..state import FIELD_NAMES

TRANSPORTS = ("gloo", "nccl", "gloo-host")

_current: "Comm | None" = None


def pick_transport(world: int, device_type: str) -> str:
    """The transport of `world` ranks on `device_type` ("cpu" or "cuda"):
    gloo on the CPU, NCCL where every rank has a card of its own, else
    gloo through host copies (ranks sharing a card)."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no transport for device type {device_type!r}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("CUDA ranks requested but torch sees no card; "
                           "pass device \"cpu\" for gloo on the CPU")
    return "nccl" if world <= count else "gloo-host"


class Comm:
    """One rank's handle on the group this process joined (init): its
    index, the group size, the transport and the device its tensors live
    on."""

    def __init__(self, rank: int, size: int, transport: str,
                 device: torch.device):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}")
        self.rank, self.size = rank, size
        self.transport, self.device = transport, torch.device(device)

    def __repr__(self) -> str:
        return (f"Comm(rank={self.rank}, size={self.size}, "
                f"transport={self.transport!r}, device={self.device})")

    def describe(self) -> str:
        """One line for logs: the transport and what it moves through."""
        how = {"gloo": "gloo over CPU tensors",
               "nccl": "NCCL, one card a rank",
               "gloo-host": "gloo through host copies (ranks share a card)"}
        return f"transport {self.transport} ({how[self.transport]})"

    def axis_index(self) -> int:
        return self.rank

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.transport == "gloo-host" else x.contiguous()

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.transport == "gloo-host" else x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' `x` concatenated along dim 0 in rank order
        (`all_gather(x, "p", tiled=True)`); differentiable for a float
        `x` (its VJP a reduce-scatter of the cotangent)."""
        if x.is_floating_point():
            return _AllGather.apply(self, x)
        return self._gather(x)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of the ranks' `x` (`psum(x, "p")`);
        differentiable for a float `x` (its VJP an all_sum of the
        cotangent)."""
        if x.is_floating_point():
            return _AllSum.apply(self, x)
        return self._sum(x)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """`x`, an operand every rank holds alike, marked as such for
        autograd: the identity, whose VJP all_sums the cotangent (the
        transpose `shard_map` applies to a `P()` input), so the gradient
        each rank reads for `x` is the one of the sum over the ranks."""
        return _Replicated.apply(self, x)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        w = self._wire(x)
        if self.transport == "nccl":
            out = w.new_empty((self.size * w.shape[0],) + tuple(w.shape[1:]))
            dist.all_gather_into_tensor(out, w)
            return out
        # gloo: the list form, which every gloo build takes
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w)
        return self._back(torch.cat(parts))

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        w = self._wire(x).clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM)
        return self._back(w)

    def _reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Rows [r n, (r + 1) n) of the sum over the ranks of `x` ((size
        n, ...) on every rank), on rank r."""
        w, n = x.contiguous(), x.shape[0] // self.size
        if self.transport == "nccl":
            out = w.new_empty((n,) + tuple(w.shape[1:]))
            dist.reduce_scatter_tensor(out, w)
            return out
        # gloo: an all_reduce of the whole tensor, then this rank's rows
        # (gloo's reduce-scatter is not in every build; all_reduce is)
        return self._sum(w)[self.rank * n:(self.rank + 1) * n]

    def shift(self, x: torch.Tensor, direction: int) -> torch.Tensor:
        """Rank k's `x` arrives at rank k + direction (direction = +1 or
        -1); a rank with no sender receives zeros
        (`ppermute(x, "p", [(k, k + direction)])`)."""
        if direction not in (1, -1):
            raise ValueError(f"direction must be +1 or -1, got {direction}")
        w = self._wire(x)
        recv = torch.zeros_like(w)
        dst, src = self.rank + direction, self.rank - direction
        ops = []
        if 0 <= dst < self.size:
            ops.append(dist.P2POp(dist.isend, w, dst))
        if 0 <= src < self.size:
            ops.append(dist.P2POp(dist.irecv, recv, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._back(recv)

    def broadcast_object(self, obj, src: int = 0):
        """A picklable object from rank `src` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self) -> None:
        dist.barrier()


class _AllGather(torch.autograd.Function):
    """Comm.all_gather with its VJP: a reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm._gather(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._reduce_scatter(g)


class _AllSum(torch.autograd.Function):
    """Comm.all_sum with its VJP: an all_sum of the cotangent."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm._sum(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._sum(g)


class _Replicated(torch.autograd.Function):
    """Comm.replicated: the identity, its VJP an all_sum of the
    cotangent."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._sum(g)


def refuse_grad(what: str, state, params=None) -> None:
    """Raise where autograd would differentiate the fused slab or halo
    path: grad mode on and a tensor of `state` (a ParticleState) or of
    `params` requiring grad. Their sweeps (K1 / K2 on a slab of query
    rows) and `shift` have no VJP here, and the JAX package does not
    differentiate these paths either: `jax.grad` through its
    make_sharded_simulate_fused or make_halo_simulate raises
    NotImplementedError (pallas_call has no VJP inside shard_map).
    Checked before any collective, alike on every rank."""
    if not torch.is_grad_enabled():
        return
    tensors = [getattr(state, f) for f in FIELD_NAMES]
    tensors += list((params or {}).values())
    if any(torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is not differentiable: its sweeps on a slab of query "
            "rows and comm.shift have no VJP, and the JAX package does "
            "not differentiate this path either (jax.grad through its "
            "fused-slab and halo simulates raises NotImplementedError: "
            "pallas_call has no VJP inside shard_map). Differentiate the "
            "all-gather path (sharded_step.make_sharded_step / "
            "make_sharded_simulate) or the single-device run "
            "(models.monodomain.simulate), or run under torch.no_grad()")


def current() -> Comm | None:
    """The Comm this process joined (init / init_from_env), or None."""
    return _current


def _rank_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init(rank: int, world: int, device_type: str, init_method: str,
         local_rank: int | None = None,
         timeout_s: float | None = None) -> Comm:
    """Join the group of `world` ranks as `rank` (init_process_group with
    the picked transport's backend) and return this rank's Comm.
    `timeout_s`: how long a collective may wait for the other ranks (the
    backend's default when None)."""
    global _current
    transport = pick_transport(world, device_type)
    dev = _rank_device(device_type, rank if local_rank is None
                       else local_rank)
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})
    dist.init_process_group("nccl" if transport == "nccl" else "gloo",
                            init_method=init_method, world_size=world,
                            rank=rank, **kw)
    _current = Comm(rank, world, transport, dev)
    return _current


def init_from_env(device_type: str) -> Comm:
    """Join the group a launcher described in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, as torchrun sets
    them)."""
    return init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                device_type, "env://",
                int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def launched_by_env() -> bool:
    """True in a process that a launcher started as one of several ranks."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def shutdown() -> None:
    """Leave the group (destroy_process_group), and drop the run loop's
    captured graphs: a graph captured over NCCL holds the group's
    communicator, which a later group of the same shape must not replay."""
    global _current
    scan.clear_cache()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _current = None


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, device_type, args, timeout_s):
    comm = init(rank, world, device_type, f"tcp://localhost:{port}",
                timeout_s=timeout_s)
    try:
        fn(comm, *args)
    finally:
        shutdown()


def spawn(fn, world: int, args: tuple = (), device_type: str = "cuda",
          timeout_s: float | None = None):
    """Run fn(comm, *args) in `world` new processes on this host, one rank
    each, and wait for all of them. `fn` must be importable by name (a
    module-level function). A rank that fails ends the others and raises
    here; `timeout_s` bounds each collective's wait (init)."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main,
                       args=(fn, world, free_port(), device_type, args,
                             timeout_s),
                       nprocs=world, join=True, start_method="spawn")
