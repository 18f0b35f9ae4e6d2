"""The port's CPU square root (ops/numerics.sqrt_rn), called first in a fresh
process: correctly rounded, repeatable and independent of the thread count.

This build's CPU float32 `torch.sqrt` is not correctly rounded (about 0.7%
of inputs 1 ulp off), and in a few fresh processes it returned values up
to 3.1e-4 relative off on about 12% of a (256, 256) input, so the port
routes every float32 square root of its CPU paths (the unfused force
phase, the shape-matching linear algebra, v1's plain sweep B) through
`sqrt_rn`. These tests pin only what holds in every process: `sqrt_rn` is
within 0 ulp of the float64 square root rounded once to float32. Each
probe runs in a new interpreter, so the call under test is the first of
its process.

Run as a script for the table of the raw `torch.sqrt` and `torch.rsqrt`
over sizes and thread counts, each in fresh processes, beside `sqrt_rn`:
    PYTHONPATH=. python tests/test_torch_cpu_sqrt.py
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sph_sm_monodomain_tpu_torch.ops.numerics import sqrt_rn

_PROBE = r"""
import hashlib, json, sys
import numpy as np, torch
from sph_sm_monodomain_tpu_torch.ops.numerics import sqrt_rn
threads, fn = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(threads)
f = {"sqrt_rn": sqrt_rn, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt}[fn]
out = {"torch": torch.__version__, "threads": torch.get_num_threads(),
       "fn": fn}
for rows, cols in map(lambda s: map(int, s.split("x")), sys.argv[3:]):
    x = np.random.default_rng(0).random((rows, cols), dtype=np.float32) \
        * np.float32(0.01) + np.float32(1e-6)
    t = torch.from_numpy(x)
    a = f(t).numpy()        # the first call of this process at this size
    b = f(t).numpy()
    r = np.sqrt(x.astype(np.float64))
    ref = (1.0 / r if fn == "rsqrt" else r).astype(np.float32)
    ulp = np.abs(a.view(np.int32).astype(np.int64) - ref.view(np.int32))
    out[f"{rows}x{cols}"] = {
        "repeat_equal": bool(np.array_equal(a, b)),
        "off": int((ulp > 0).sum()), "max_ulp": int(ulp.max()),
        "max_rel": float(np.abs(a / ref.astype(np.float64) - 1.0).max()),
        "digest": hashlib.sha256(a.tobytes()).hexdigest()[:16]}
print(json.dumps(out))
"""

SIZES = ("256x256", "1024x1024")   # where the fault was seen; past the grain
_ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def probe(threads: int, fn: str = "sqrt_rn", sizes: tuple = SIZES,
          run: int = 0) -> dict:
    """One fresh-process probe of `fn` on seeded float32 inputs in
    [1e-6, 0.01) of each size, at `threads` threads (`run` tells repeated
    probes apart)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(threads), fn,
                          *sizes], check=True, capture_output=True,
                         text=True, timeout=120, env=env)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("threads", [1, 4])
def test_first_sqrt_repeatable_and_within_1ulp(threads):
    """sqrt_rn, first called in a fresh process: correctly rounded (0 ulp)
    at both sizes, and a second call gives the same bits."""
    r = probe(threads)
    assert r["threads"] == threads
    for size in SIZES:
        assert r[size]["max_ulp"] == 0, (size, r[size])
        assert r[size]["repeat_equal"], (size, r[size])


def test_first_sqrt_independent_of_threads():
    """The same bits in every process: at 1 and 4 threads, and in a second
    fresh process at 1 thread."""
    runs = [probe(1), probe(4), probe(1, run=1)]
    for size in SIZES:
        assert len({r[size]["digest"] for r in runs}) == 1, \
            [r[size] for r in runs]


def test_sqrt_rn_edges_and_gradient():
    """0, +inf, NaN and subnormals pass through as IEEE sqrt gives them,
    other dtypes take torch.sqrt, and the gradient is torch.sqrt's,
    grad / (2 sqrt(x)), on the correctly rounded value."""
    x = torch.tensor([0.0, float("inf"), float("nan"), 1e-45, 2.0, 1e30])
    want = np.sqrt(x.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(x).numpy(), want)
    xd = x.double()
    torch.testing.assert_close(sqrt_rn(xd), torch.sqrt(xd), rtol=0.0,
                               atol=0.0, equal_nan=True)
    v = torch.tensor([0.25, 2.0, 9.0], requires_grad=True)
    (g,) = torch.autograd.grad((sqrt_rn(v) * torch.tensor([1.0, 2.0, 3.0]))
                               .sum(), v)
    y = np.sqrt(np.array([0.25, 2.0, 9.0])).astype(np.float32)
    np.testing.assert_allclose(g.numpy(), np.array([1.0, 2.0, 3.0]) / (2 * y),
                               rtol=1e-7)


if __name__ == "__main__":
    print(f"torch {torch.__version__}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}, default threads "
          f"{torch.get_num_threads()}")
    sizes = ("16x16", "256x256", "256x576", "1024x1024", "18560x512")
    for fn in ("sqrt", "rsqrt", "sqrt_rn"):
        for threads in (1, 8):
            for run in range(3):
                print(json.dumps(probe(threads, fn, sizes, run)), flush=True)
