"""The run loop of the port: the counterpart of the JAX package's jitted
`lax.scan` (sph_sm_monodomain_tpu/models/monodomain.py:255-346,
models/variants.py:143-177), and of `jax.jit(jax.value_and_grad(...))`
over a `jax.checkpoint`ed scan of it.

`run_steps` runs a step function `num_steps` times under the reference
app's protocol: turnOffStim before one step index, a frame after each full
block of `record_every` steps, the largest per-step overflow. The steps
run in blocks of at most `unroll`, cut at the stim-off index and at the
frames (`schedule`).

On a CUDA state each block is one replay of a `torch.cuda.CUDAGraph`
that captured that many steps over static buffers and ends by copying the
last step's state back into them, so a replay advances the state in place
and the host issues one graph launch where the eager step issues one launch
per kernel. The first call for a key runs step 0 eagerly: it builds the
kernels and fills the constant cache, which a capture must not do. Then
it captures, and caches the capture under the caller's static key plus the
shapes, dtypes and device of the state and operands (the JAX package's
`_SIM_STATIC` and its argument shapes). A later call copies its state and
operands into the buffers and replays. A block shorter than `unroll`
(a leftover, or one cut by the stim-off or a frame) has a capture of its
own. The stim-off runs between replays as an in-place write of its fields
into the buffers (the JAX package's `lax.cond`); frames are cloned
between replays. A capture or replay that fails raises: nothing falls back
to the eager loop on the card.

Under autograd (grad mode on, and a tensor of the state or the operands
requiring grad) the steps run as a checkpointed adjoint scan
(`_CheckpointedScan`), `jax.checkpoint`'s policy: the forward pass keeps
one carry per step (the state before it) and nothing of the step's
internals; the backward pass walks the steps in reverse, and for step t
recomputes the step from carry t under autograd, takes its VJP with
`torch.autograd.grad` against the cotangent of state t + 1, and adds the
operands' cotangents into accumulators. Frames are differentiable outputs
(their cotangents enter through the VJP of `extract` where they were
taken), and the stim-off's cotangent is the VJP of its write. The forward
runs one step a block (each step's carry is saved), on the card as
replays of the one-step capture above; the backward step (recompute, VJP
and accumulation) is one more captured graph, cached beside the forward's
under the same key, the shapes and which operands require grad, and
replayed once a step. Its first step for a key runs eagerly (the warm-up:
constants, autograd's state, cuBLAS's backward workspace), the next
captures. On the CPU the same forward and backward steps run eagerly.
`donate` is ignored under autograd: the input state is carry 0.

On a CPU state without autograd the blocks run eagerly.

The multi-device simulates (parallel/) run their steps here too, graphed
over NCCL: a captured step holds its collectives, so every rank must make
the same captures in the same order (their keys name the rank). The
default "global" capture mode holds: ProcessGroupNCCL's watchdog thread,
which queries the events of finished collectives, does not end a capture
(chip_smoke.py's NCCL capture probe). Under autograd the all-gather
path's backward step holds the recompute's collectives and their VJPs'
(parallel/comm.py), captured on autograd's device thread like any other
backward step; every rank's autograd engine runs the same graph in the
same order, so the ranks issue the same collectives in the same order.

`donate=True` makes the input state's own tensors the graph's buffers:
the result is written into them and returned, and the input is dead after
the call (the JAX package's `donate_argnums`). A donated call whose state
is the buffers of the cached capture (the previous chunk's result)
replays without a copy; another state is captured anew. Without
`donate` the buffers belong to the cache and the result is a copy.

Launch counts: a replay launches kernels without running their wrappers,
so the counters of ops/cuda_lib.launch_counters() are corrected: what a
capture counted is taken off (nothing ran), and each replay adds what its
capture counted. The counters of utils/tracing.DEVICE_COUNTERS (bumped
inside a step) take the same correction.

Tracing (utils/tracing.py): while it is on, the run loop records the spans
`scan.warmup` (the eager step 0 of a new capture), `scan.capture` (capture
and instantiation of one block length; attribute: the steps it holds),
`scan.replay` (the host's time in `graph.replay()`; `first` marks the
first replay after a capture, which uploads the graph) and `scan.stim_off`,
and the counters `scan.warmups`, `scan.replays`, `scan.captures` (graphs
captured),`scan.captures.<why>` (why a key's
buffers and graphs were made anew: `new_key`, `not_held` where a donated
state is not the cached capture's buffers, `evicted` where the LRU dropped
the key) and `scan.graph_kernels`: the kernel nodes of each captured
graph, counted once from the graph itself (kept for that while tracing is
on), stamps left out. Tracing's state is part of the capture key, so a
graph captured with the step's device stamps is never replayed untraced,
and the graphs captured untraced hold no stamps.
"""

from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager, nullcontext

import torch
from torch.utils import _pytree as pytree

from ..ops import cuda_lib
from ..state import FIELD_NAMES, ParticleState
from ..utils import tracing

STIM_OFF, FRAME = "stim_off", "frame"
# captures kept at once (the least recently used goes first); each holds
# its buffers and its graphs' memory pool
MAX_CAPTURES = 8

_captures: OrderedDict = OrderedDict()
_graphed = True     # False inside eager()
_evicted: set = set()   # keys the LRU dropped while tracing was on


def clear_cache() -> None:
    """Drop every cached capture, with its buffers and memory pool."""
    _captures.clear()
    _evicted.clear()


@contextmanager
def eager():
    """Inside, run_steps runs every step eagerly on the card too, the
    adjoint scan's forward and backward steps included: the reference its
    captured graphs are held to (chip_smoke.py, tests/test_torch_cuda.py).
    A backward pass runs as its forward did."""
    global _graphed
    prev, _graphed = _graphed, False
    try:
        yield
    finally:
        _graphed = prev


def schedule(num_steps: int, unroll: int, stim_off_step: int = -1,
             record_every: int = 0, start: int = 0) -> list:
    """Steps `start` .. `num_steps` - 1 as a list of events: STIM_OFF
    (turnOffStim before the next step), FRAME (a frame of the state after
    the steps so far) or an int n (n steps as one block, n <= unroll).
    Blocks are cut before the stim-off index and after every step count
    that is a multiple of `record_every`."""
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    cuts = {start, num_steps}
    if start <= stim_off_step < num_steps:
        cuts.add(stim_off_step)
    if record_every:
        cuts.update(range(record_every * (start // record_every + 1),
                          num_steps + 1, record_every))
    cuts = sorted(c for c in cuts if start <= c <= num_steps)
    events = []
    for a, b in zip(cuts, cuts[1:]):
        if a == stim_off_step:
            events.append(STIM_OFF)
        n = b - a
        events += [unroll] * (n // unroll) + ([n % unroll] if n % unroll
                                              else [])
        if record_every and b % record_every == 0:
            events.append(FRAME)
    return events


def _leaves(state) -> list:
    """The tensors of a state: a ParticleState's fields, or the tensor."""
    if isinstance(state, ParticleState):
        return [getattr(state, f) for f in FIELD_NAMES]
    return [state]


def _like(state, leaves):
    return ParticleState(*leaves) if isinstance(state, ParticleState) \
        else leaves[0]


def copy_state(state):
    """A copy of a state (a ParticleState or a tensor) in fresh contiguous
    tensors."""
    return _like(state, [t.clone(memory_format=torch.contiguous_format)
                         for t in _leaves(state)])


def _copy_leaves(dsts, srcs) -> None:
    """Write each tensor of `srcs` into the tensor of `dsts` at its index.
    A source that shares memory with a destination is copied first, so no
    write clobbers what another still has to read."""
    pairs = [(d, s) for d, s in zip(dsts, srcs) if s is not d]
    mem = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in mem else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


def _assign(dst, src) -> None:
    """Write state `src` into the tensors of state `dst` (_copy_leaves)."""
    _copy_leaves(_leaves(dst), _leaves(src))


def _frame(extract, state) -> tuple:
    return tuple(x.clone() for x in extract(state))


def _run_eager(step, state, operands, events, stim_off, extract, hook=None):
    """(state, overflow, frames) of `events` run eagerly from `state`.
    `hook(event, state)` sees the state before each event."""
    cur, frames = state, []
    overflow = torch.zeros((), dtype=torch.int32,
                           device=_leaves(state)[0].device)
    for ev in events:
        if hook is not None:
            hook(ev, cur)
        if ev == STIM_OFF:
            with tracing.span("scan.stim_off"):
                cur = stim_off(cur)
        elif ev == FRAME:
            frames.append(_frame(extract, cur))
        else:
            for _ in range(ev):
                cur, aux = step(cur, operands)
                if aux is not None:
                    overflow = torch.maximum(overflow, aux.overflow)
    return cur, overflow, frames


def _read_counters() -> tuple:
    """The launch counters, then tracing's DEVICE_COUNTERS (the last one:
    the stamps launched)."""
    return cuda_lib.read_counters() + tracing.read_device_counters()


def _add_counters(delta) -> None:
    cuda_lib.add_counters(delta)
    tracing.add_device_counters(delta)


def _capture(body, pool):
    """(graph, counter deltas): `body()` captured as a CUDA graph into the
    memory pool `pool` (torch.cuda.graph_pool_handle). Nothing runs during
    a capture, so what the counters counted is taken off again; a replay
    adds it back. While tracing is on the graph is kept to count its
    kernel nodes (stamps left out), then instantiated."""
    traced = tracing.on()
    before = _read_counters()
    graph = torch.cuda.CUDAGraph(keep_graph=True) if traced \
        else torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool):
            body()
    finally:
        counted = tuple(a - b for a, b in zip(_read_counters(), before))
        _add_counters(tuple(-d for d in counted))
    if traced:
        graph.instantiate()
        graph.trace_info = {"kernels": tracing.graph_nodes(graph)["kernel"]
                            - counted[-1], "steps": 1, "replayed": False}
    return graph, counted


def _traced_capture(body, pool, steps: int):
    """_capture(body, pool) in the span `scan.capture`, counted by tracing
    with the steps its graph holds."""
    with tracing.span("scan.capture", steps=steps):
        graph, counted = _capture(body, pool)
    info = getattr(graph, "trace_info", None)
    if info is not None:
        info["steps"] = steps
        tracing.count("scan.captures")
        tracing.count("scan.graph_kernels", info["kernels"])
    return graph, counted


def _replay(graph, counted) -> None:
    if tracing.on():
        _replay_traced(graph, counted)
        return
    graph.replay()
    _add_counters(counted)


def _replay_traced(graph, counted) -> None:
    info = getattr(graph, "trace_info", {})
    with tracing.span("scan.replay", first=info.get("replayed") is False,
                      kernels=info.get("kernels"), steps=info.get("steps")):
        graph.replay()
    info["replayed"] = True
    tracing.count("scan.replays")
    _add_counters(counted)


class _Capture:
    """The static buffers, operands and graphs of one key."""

    def __init__(self, bufs, op_leaves, op_spec, device):
        self.bufs = bufs
        self.op_leaves = [torch.empty_like(t, device=device).copy_(t)
                          if torch.is_tensor(t) else t for t in op_leaves]
        self.operands = pytree.tree_unflatten(self.op_leaves, op_spec)
        self.overflow = torch.zeros((), dtype=torch.int32, device=device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}    # block length -> (CUDAGraph, counter deltas)

    def holds(self, leaves) -> bool:
        return all(a.data_ptr() == b.data_ptr() and a.shape == b.shape
                   and a.stride() == b.stride()
                   for a, b in zip(leaves, _leaves(self.bufs)))

    def load_operands(self, op_leaves) -> None:
        for dst, src in zip(self.op_leaves, op_leaves):
            if torch.is_tensor(dst):
                dst.copy_(src)

    def replay(self, step, length: int) -> None:
        if length not in self.graphs:
            self.graphs[length] = self._capture(step, length)
        _replay(*self.graphs[length])

    def _capture(self, step, length: int):
        return _traced_capture(lambda: self._steps(step, length), self.pool,
                               length)

    def _steps(self, step, length: int) -> None:
        st = self.bufs
        for _ in range(length):
            st, aux = step(st, self.operands)
            if aux is not None:
                torch.maximum(self.overflow, aux.overflow, out=self.overflow)
        _assign(self.bufs, st)


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype) if torch.is_tensor(t) else t
                 for t in leaves)


def _full_key(key, unroll, donate, leaves, op_leaves, op_spec) -> tuple:
    return (key, unroll, donate, leaves[0].device, _signature(leaves),
            op_spec, _signature(op_leaves), tracing.on())


def _cache(full_key, entry) -> None:
    _captures[full_key] = entry
    while len(_captures) > MAX_CAPTURES:
        old = _captures.popitem(last=False)[0]
        if tracing.on():
            _evicted.add(old)


def run_steps_eager(step, state, num_steps: int, *, key=None, operands=(),
                    unroll: int = 1, stim_off_step: int = -1,
                    stim_off=None, record_every: int = 0, extract=None,
                    donate: bool = False):
    """`run_steps` with every block run eagerly, under plain autograd where
    a tensor requires grad: its path on the CPU, and the reference its
    graphed and adjoint paths are held to."""
    _check_donated(state, donate)
    cur, overflow, frames = _run_eager(
        step, state, operands,
        schedule(num_steps, unroll, stim_off_step, record_every), stim_off,
        extract)
    if donate:
        _assign(state, cur)
        cur = state
    return cur, overflow, frames


def run_steps_uncaptured(step, state, num_steps: int, **kw):
    """`run_steps` with nothing captured, as inside `eager()`: the blocks
    eagerly, and under autograd the checkpointed adjoint scan with its
    forward and backward steps eager (one carry a step). For steps whose
    collectives copy through host memory, which no capture can hold."""
    with eager():
        return run_steps(step, state, num_steps, **kw)


def _check_donated(state, donate: bool) -> None:
    leaves = _leaves(state)
    if donate and len({t.data_ptr() for t in leaves}) < len(leaves):
        raise ValueError("a donated state's fields must not share memory")


def run_steps(step, state, num_steps: int, *, key, operands=(),
              unroll: int = 1, stim_off_step: int = -1, stim_off=None,
              record_every: int = 0, extract=None, donate: bool = False):
    """Run `num_steps` steps of `step(state, operands) -> (state, aux)`
    (`aux.overflow` a 0-dim int32 tensor, or aux None) from `state` (a
    ParticleState or a tensor). Returns (state, overflow, frames): the
    largest per-step overflow as a 0-dim int32 tensor on the state's
    device, and a list of `extract(state)` tuples, one after each full
    block of `record_every` steps.

    `key`: a hashable value that, with the shapes, dtypes and device of the
    state and operands, fixes everything the step does. Every tensor the
    step reads that may differ between calls of one key must come through
    `operands` (a pytree: its tensors are copied into the capture's own on
    each call, its other leaves join the key); constant tensors must stay
    alive at their address (ops/constants.const_tensor). `stim_off(state)
    -> state` runs before step `stim_off_step` (-1: never).

    Under autograd the result, the frames and their gradients come from
    the checkpointed adjoint scan (module docstring), differentiable
    w.r.t. the state's float tensors and the operands' tensors that
    require grad."""
    leaves = _leaves(state)
    op_leaves, op_spec = pytree.tree_flatten(operands)
    device = leaves[0].device
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves + op_leaves if torch.is_tensor(t))
    kw = dict(stim_off_step=stim_off_step, stim_off=stim_off,
              record_every=record_every, extract=extract)
    if num_steps <= 0 or not (needs_grad or (device.type == "cuda"
                                             and _graphed)):
        return run_steps_eager(step, state, num_steps, operands=operands,
                               unroll=unroll, donate=donate, **kw)
    if needs_grad:
        return _adjoint_scan(step, state, num_steps, key, op_leaves,
                             op_spec, **kw)
    _check_donated(state, donate)
    full_key = _full_key(key, unroll, donate, leaves, op_leaves, op_spec)
    entry, overflow, frames = _run_graphed(step, state, operands, op_leaves,
                                           full_key, num_steps, **kw)
    out = entry.bufs if donate else copy_state(entry.bufs)
    return out, overflow, frames


def _run_graphed(step, state, operands, op_leaves, full_key, num_steps,
                 *, stim_off_step, stim_off, record_every, extract,
                 hook=None):
    """Run the steps through the cached capture of `full_key` (made and
    cached on a first call): returns (capture, its overflow, frames), the
    final state in the capture's buffers. `hook` as in _run_eager, which
    sees a block of n steps once."""
    key, unroll, donate, device = full_key[:4]
    leaves = _leaves(state)
    entry = _captures.get(full_key)
    why = "new_key"
    if entry is not None and donate and not entry.holds(leaves):
        del _captures[full_key]
        entry, why = None, "not_held"
    try:
        with torch.cuda.device(device):
            if entry is None:
                if why == "new_key" and full_key in _evicted:
                    why = "evicted"
                _evicted.discard(full_key)
                tracing.count(f"scan.captures.{why}")
                tracing.count("scan.warmups")
                # the warm-up: step 0 eagerly, on the caller's state
                with tracing.span("scan.warmup"):
                    cur, overflow, frames = _run_eager(
                        step, state, operands,
                        schedule(1, 1, stim_off_step, record_every),
                        stim_off, extract, hook)
                if donate:
                    _assign(state, cur)
                    bufs = state
                else:
                    bufs = copy_state(cur)
                entry = _Capture(bufs, op_leaves, full_key[5], device)
                entry.overflow.copy_(overflow)
                _cache(full_key, entry)
                start = 1
            else:
                _captures.move_to_end(full_key)
                if not donate:
                    _assign(entry.bufs, state)
                entry.load_operands(op_leaves)
                entry.overflow.zero_()
                frames, start = [], 0
            for ev in schedule(num_steps, unroll, stim_off_step,
                               record_every, start):
                if hook is not None:
                    hook(ev, entry.bufs)
                if ev == STIM_OFF:
                    with tracing.span("scan.stim_off"):
                        _assign(entry.bufs, stim_off(entry.bufs))
                elif ev == FRAME:
                    frames.append(_frame(extract, entry.bufs))
                else:
                    entry.replay(step, ev)
    except BaseException:
        _captures.pop(full_key, None)
        raise
    return entry, entry.overflow.clone(), frames


# --- the checkpointed adjoint scan ------------------------------------------

class _Backward:
    """One backward step of a key over static buffers: carry t and the
    cotangent of state t + 1 in, the cotangent of state t out (in place),
    the operands' cotangents added into accumulators. Eager on the CPU; on
    the card its first run is eager and the next one captures it."""

    def __init__(self, plan, leaves, op_vals):
        self.step, self.graphed = plan.step, plan.graphed
        self.particles = isinstance(plan.template, ParticleState)
        self.x = [torch.empty_like(t).requires_grad_(t.is_floating_point())
                  for t in leaves]
        self.fx = [x for x in self.x if x.requires_grad]
        ops = [torch.empty_like(v).requires_grad_(m) if torch.is_tensor(v)
               else v for v, m in zip(op_vals, plan.op_grad)]
        self.gops = [o for o, m in zip(ops, plan.op_grad) if m]
        self.operands = pytree.tree_unflatten(ops, plan.op_spec)
        self.op_static = ops
        self.g = [torch.zeros_like(x) for x in self.fx]
        self.acc = [torch.zeros_like(o) for o in self.gops]
        self.warm = False
        self.graph = None

    def load_operands(self, op_vals) -> None:
        with torch.no_grad():
            for dst, src in zip(self.op_static, op_vals):
                if torch.is_tensor(dst):
                    dst.copy_(src)
            for a in self.acc:
                a.zero_()

    def run(self, carry) -> None:
        """One step back from carry `carry` (a list of tensors)."""
        with torch.no_grad():
            torch._foreach_copy_(self.x, carry)
        if not (self.graphed and self.warm):
            self.warm = True
            self._body()
            return
        if self.graph is None:
            self.graph = _traced_capture(
                self._body, torch.cuda.graph_pool_handle(), 1)
        _replay(*self.graph)

    def _body(self) -> None:
        with torch.enable_grad():
            st = ParticleState(*self.x) if self.particles else self.x[0]
            out = self.step(st, self.operands)[0]
            outs = [o for o, x in zip(_leaves(out), self.x)
                    if x.requires_grad]
            grads = _grads(outs, self.g, self.fx + self.gops)
        nx = len(self.fx)
        _copy_leaves(self.g, [torch.zeros_like(d) if gr is None else gr
                              for d, gr in zip(self.g, grads[:nx])])
        for a, gr in zip(self.acc, grads[nx:]):
            if gr is not None:
                a.add_(gr)


def _grads(outs, cots, ins) -> list:
    """torch.autograd.grad of the outputs `outs` against their cotangents
    `cots` (None: none) w.r.t. `ins`; None for an input nothing reaches."""
    pairs = [(o, c) for o, c in zip(outs, cots)
             if c is not None and o.requires_grad]
    if not pairs:
        return [None] * len(ins)
    return list(torch.autograd.grad([o for o, _ in pairs], ins,
                                    [c for _, c in pairs],
                                    allow_unused=True))


def _vjp(fn, state, cots) -> list:
    """Cotangents of `state`'s float tensors from those of the tensors of
    fn(state) (`cots`, in their order; None: no cotangent)."""
    xs = [t.detach().requires_grad_(t.is_floating_point())
          for t in _leaves(state)]
    fx = [x for x in xs if x.requires_grad]
    with torch.enable_grad():
        out = fn(_like(state, xs))
        outs = _leaves(out) if isinstance(out, (ParticleState,
                                                torch.Tensor)) else out
        grads = _grads(outs, cots, fx)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(fx, grads)]


class _Plan:
    """What a _CheckpointedScan call runs: the step, the protocol, the
    shape of the state and operands."""

    def __init__(self, step, state, num_steps, key, op_leaves, op_spec,
                 stim_off_step, stim_off, record_every, extract):
        self.step, self.template = step, state
        self.n = len(_leaves(state))
        self.op_leaves, self.op_spec = op_leaves, op_spec
        self.op_grad = tuple(torch.is_tensor(t) and t.requires_grad
                             for t in op_leaves)
        self.events = schedule(num_steps, 1, stim_off_step, record_every)
        self.num_steps, self.key = num_steps, key
        self.stim_off_step, self.record_every = stim_off_step, record_every
        self.stim_off, self.extract = stim_off, extract
        self.graphed = _graphed and _leaves(state)[0].device.type == "cuda"
        self.frame_len = 0

    def operand_values(self, tensors) -> list:
        it = iter(tensors)
        return [next(it) if torch.is_tensor(t) else t for t in self.op_leaves]

    def full_key(self, leaves, op_vals) -> tuple:
        return _full_key(self.key, 1, False, leaves, op_vals, self.op_spec)


class _CheckpointedScan(torch.autograd.Function):
    """The steps of a _Plan as one differentiable op. Inputs: the plan, the
    state's tensors, the operands' tensors. Outputs: the final state's
    tensors, the frames' tensors, the overflow."""

    @staticmethod
    def forward(ctx, plan, *tensors):
        leaves = [t.detach() for t in tensors[:plan.n]]
        op_vals = plan.operand_values([t.detach() for t in tensors[plan.n:]])
        state = _like(plan.template, leaves)
        operands = pytree.tree_unflatten(op_vals, plan.op_spec)
        carries = [torch.empty((plan.num_steps,) + t.shape, dtype=t.dtype,
                               device=t.device) for t in leaves]
        saved = {"t": 0, "pre_stim": None}

        def hook(ev, st):
            if ev == STIM_OFF:
                saved["pre_stim"] = copy_state(st)
            elif ev != FRAME:
                torch._foreach_copy_([c[saved["t"]] for c in carries],
                                     _leaves(st))
                saved["t"] += 1

        kw = dict(stim_off=plan.stim_off, extract=plan.extract, hook=hook)
        if plan.graphed:
            entry, overflow, frames = _run_graphed(
                plan.step, state, operands, op_vals,
                plan.full_key(leaves, op_vals), plan.num_steps,
                stim_off_step=plan.stim_off_step,
                record_every=plan.record_every, **kw)
            cur = entry.bufs
        else:
            cur, overflow, frames = _run_eager(plan.step, state, operands,
                                               plan.events, **kw)
        final = _leaves(copy_state(cur))
        plan.frame_len = len(frames[0]) if frames else 0
        outs = final + [t for f in frames for t in f] + [overflow]
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*final)
        ctx.plan, ctx.carries, ctx.pre_stim = plan, carries, saved["pre_stim"]
        ctx.op_vals, ctx.n_frames = op_vals, len(frames)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        final = list(ctx.saved_tensors)
        leaves = [c[0] for c in ctx.carries]
        bkey = ("backward", plan.graphed, plan.full_key(leaves, ctx.op_vals),
                plan.op_grad)
        bwd = _captures.get(bkey)
        try:
            if bwd is None:
                bwd = _Backward(plan, leaves, ctx.op_vals)
                _cache(bkey, bwd)
            else:
                _captures.move_to_end(bkey)
            with (torch.cuda.device(leaves[0].device)
                  if leaves[0].device.type == "cuda" else nullcontext()):
                _adjoint_walk(ctx, bwd, final, grads)
        except BaseException:
            _captures.pop(bkey, None)
            raise
        g = iter(bwd.g)
        out = [None]
        for t, need in zip(final, ctx.needs_input_grad[1:plan.n + 1]):
            gt = next(g) if t.is_floating_point() else None
            out.append(gt.clone() if need and gt is not None else None)
        acc = iter(bwd.acc)
        for t, m in zip(plan.op_leaves, plan.op_grad):
            if torch.is_tensor(t):
                out.append(next(acc).clone() if m else None)
        return tuple(out)


def _adjoint_walk(ctx, bwd, final, grads) -> None:
    """The reverse of the forward's events, leaving the cotangent of the
    initial state in bwd.g and the operands' in bwd.acc."""
    plan = ctx.plan
    n, k = plan.n, plan.frame_len
    floats = [t.is_floating_point() for t in final]
    bwd.load_operands(ctx.op_vals)
    with torch.no_grad():
        _copy_leaves(bwd.g, [torch.zeros_like(t) if gr is None else gr
                             for t, gr, f in zip(final, grads[:n], floats)
                             if f])
    frame_cots = grads[n:n + k * ctx.n_frames]
    fi, t = ctx.n_frames, plan.num_steps
    cur = _like(plan.template, final)
    for ev in reversed(plan.events):
        if ev == FRAME:
            fi -= 1
            cots = frame_cots[fi * k:(fi + 1) * k]
            if any(c is not None for c in cots):
                add = _vjp(plan.extract, cur, cots)
                with torch.no_grad():
                    torch._foreach_add_(bwd.g, add)
        elif ev == STIM_OFF:
            cur = ctx.pre_stim
            it = iter(bwd.g)
            cots = [next(it) if f else None for f in floats]
            new = _vjp(plan.stim_off, cur, cots)
            with torch.no_grad():
                _copy_leaves(bwd.g, new)
        else:
            t -= 1
            carry = [c[t] for c in ctx.carries]
            bwd.run(carry)
            cur = _like(plan.template, carry)


def _adjoint_scan(step, state, num_steps, key, op_leaves, op_spec, *,
                  stim_off_step, stim_off, record_every, extract):
    """run_steps under autograd: the steps as one _CheckpointedScan."""
    plan = _Plan(step, state, num_steps, key, op_leaves, op_spec,
                 stim_off_step, stim_off, record_every, extract)
    outs = _CheckpointedScan.apply(
        plan, *_leaves(state), *[t for t in op_leaves if torch.is_tensor(t)])
    n, k = plan.n, plan.frame_len
    flat = outs[n:-1]
    frames = [tuple(flat[i:i + k]) for i in range(0, len(flat), k)] \
        if k else []
    return _like(state, list(outs[:n])), outs[-1], frames
