"""The run loop of the port: the counterpart of the JAX package's jitted
`lax.scan` (sph_sm_monodomain_tpu/models/monodomain.py:255-346,
models/variants.py:143-177).

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

On a CPU state, or where a tensor of the state or the operands requires
grad while grad mode is on, the same blocks run eagerly.

`donate=True` makes the input state's own tensors the graph's buffers:
the result is written into them and returned, and the input is dead after
the call (the JAX package's `donate_argnums`). A donated call whose state
is the buffers of the cached capture (the previous chunk's result)
replays without a copy; another state is captured anew. Without
`donate` the buffers belong to the cache and the result is a copy.

Launch counts: a replay launches kernels without running their wrappers,
so the counters of ops/cuda_lib.launch_counters() are corrected: what a
capture counted is taken off (nothing ran), and each replay adds what its
capture counted.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch.utils import _pytree as pytree

from ..ops import cuda_lib
from ..state import FIELD_NAMES, ParticleState

STIM_OFF, FRAME = "stim_off", "frame"
# captures kept at once (the least recently used goes first); each holds
# its buffers and its graphs' memory pool
MAX_CAPTURES = 8

_captures: OrderedDict = OrderedDict()


def clear_cache() -> None:
    """Drop every cached capture, with its buffers and memory pool."""
    _captures.clear()


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


def _assign(dst, src) -> None:
    """Write state `src` into the tensors of state `dst`. A source that
    shares memory with a destination is copied first, so no write clobbers
    what another field still has to read."""
    pairs = [(d, s) for d, s in zip(_leaves(dst), _leaves(src)) if s is not d]
    mem = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in mem else s)
             for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


def _frame(extract, state) -> tuple:
    return tuple(x.clone() for x in extract(state))


def _run_eager(step, state, operands, events, stim_off, extract):
    """(state, overflow, frames) of `events` run eagerly from `state`."""
    cur, frames = state, []
    overflow = torch.zeros((), dtype=torch.int32,
                           device=_leaves(state)[0].device)
    for ev in events:
        if ev == STIM_OFF:
            cur = stim_off(cur)
        elif ev == FRAME:
            frames.append(_frame(extract, cur))
        else:
            for _ in range(ev):
                cur, aux = step(cur, operands)
                if aux is not None:
                    overflow = torch.maximum(overflow, aux.overflow)
    return cur, overflow, frames


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
        graph, delta = self.graphs[length]
        graph.replay()
        cuda_lib.add_counters(delta)

    def _capture(self, step, length: int):
        before = cuda_lib.read_counters()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                st = self.bufs
                for _ in range(length):
                    st, aux = step(st, self.operands)
                    if aux is not None:
                        torch.maximum(self.overflow, aux.overflow,
                                      out=self.overflow)
                _assign(self.bufs, st)
        finally:
            counted = tuple(a - b for a, b in
                            zip(cuda_lib.read_counters(), before))
            cuda_lib.add_counters(tuple(-d for d in counted))
        return graph, counted


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype) if torch.is_tensor(t) else t
                 for t in leaves)


def run_steps_eager(step, state, num_steps: int, *, key=None, operands=(),
                    unroll: int = 1, stim_off_step: int = -1,
                    stim_off=None, record_every: int = 0, extract=None,
                    donate: bool = False):
    """`run_steps` with every block run eagerly: its path on the CPU and
    under autograd, and the reference its graphed path is held to."""
    _check_donated(state, donate)
    cur, overflow, frames = _run_eager(
        step, state, operands,
        schedule(num_steps, unroll, stim_off_step, record_every), stim_off,
        extract)
    if donate:
        _assign(state, cur)
        cur = state
    return cur, overflow, frames


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
    -> state` runs before step `stim_off_step` (-1: never)."""
    leaves = _leaves(state)
    op_leaves, op_spec = pytree.tree_flatten(operands)
    device = leaves[0].device
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves + op_leaves if torch.is_tensor(t))
    if device.type != "cuda" or needs_grad or num_steps <= 0:
        return run_steps_eager(
            step, state, num_steps, operands=operands, unroll=unroll,
            stim_off_step=stim_off_step, stim_off=stim_off,
            record_every=record_every, extract=extract, donate=donate)
    _check_donated(state, donate)

    full_key = (key, unroll, donate, device, _signature(leaves), op_spec,
                _signature(op_leaves))
    entry = _captures.get(full_key)
    if entry is not None and donate and not entry.holds(leaves):
        del _captures[full_key]
        entry = None
    try:
        with torch.cuda.device(device):
            if entry is None:
                # the warm-up: step 0 eagerly, on the caller's state
                cur, overflow, frames = _run_eager(
                    step, state, operands,
                    schedule(1, 1, stim_off_step, record_every), stim_off,
                    extract)
                if donate:
                    _assign(state, cur)
                    bufs = state
                else:
                    bufs = copy_state(cur)
                entry = _Capture(bufs, op_leaves, op_spec, device)
                entry.overflow.copy_(overflow)
                _captures[full_key] = entry
                while len(_captures) > MAX_CAPTURES:
                    _captures.popitem(last=False)
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
                if ev == STIM_OFF:
                    _assign(entry.bufs, stim_off(entry.bufs))
                elif ev == FRAME:
                    frames.append(_frame(extract, entry.bufs))
                else:
                    entry.replay(step, ev)
    except BaseException:
        _captures.pop(full_key, None)
        raise
    out = entry.bufs if donate else copy_state(entry.bufs)
    return out, entry.overflow.clone(), frames
