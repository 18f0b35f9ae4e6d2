"""torch.sqrt on the CPU, called first in a fresh process: is it repeatable,
independent of the thread count, and how far from the correctly rounded
square root?

The unfused force phase (sph_sm_monodomain_tpu_torch/ops/sph.py) takes
r = sqrt(r^2) as the JAX package does; these tests pin the properties of
the CPU sqrt that its parity tests rely on. Each probe runs in a new
interpreter, so the sqrt under test is the first call of its process.

Run as a script for the table over sizes and thread counts:
    python tests/test_torch_cpu_sqrt.py
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys

import pytest

_PROBE = r"""
import hashlib, json, sys
import numpy as np, torch
rows, cols, threads = map(int, sys.argv[1:4])
torch.set_num_threads(threads)
x = np.random.default_rng(0).random((rows, cols), dtype=np.float32) \
    * np.float32(0.01)
t = torch.from_numpy(x)
a = torch.sqrt(t).numpy()          # the first call of this process
b = torch.sqrt(t).numpy()
ref = np.sqrt(x.astype(np.float64)).astype(np.float32)   # correctly rounded
ulp = np.abs(a.view(np.int32).astype(np.int64) - ref.view(np.int32))
print(json.dumps({
    "torch": torch.__version__, "threads": torch.get_num_threads(),
    "elements": int(x.size), "repeat_equal": bool(np.array_equal(a, b)),
    "off_1ulp": int((ulp == 1).sum()), "max_ulp": int(ulp.max()),
    "digest": hashlib.sha256(a.tobytes()).hexdigest()[:16]}))
"""

ROWS, COLS = 1024, 1024   # 1 M elements: well past torch's parallel grain


@functools.lru_cache(maxsize=None)
def probe(rows: int, cols: int, threads: int) -> dict:
    """One fresh-process probe: the first torch.sqrt of a seeded
    (rows, cols) f32 tensor in [0, 0.01) at `threads` threads."""
    out = subprocess.run([sys.executable, "-c", _PROBE, str(rows),
                          str(cols), str(threads)], check=True,
                         capture_output=True, text=True, timeout=120)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("threads", [1, 4])
def test_first_sqrt_repeatable_and_within_1ulp(threads):
    r = probe(ROWS, COLS, threads)
    assert r["threads"] == threads
    assert r["repeat_equal"], r
    assert r["max_ulp"] <= 1, r


def test_first_sqrt_independent_of_threads():
    one, four = probe(ROWS, COLS, 1), probe(ROWS, COLS, 4)   # cached
    assert one["digest"] == four["digest"], (one, four)


if __name__ == "__main__":
    import torch
    print(f"torch {torch.__version__}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}, default threads "
          f"{torch.get_num_threads()}")
    for rows, cols in ((16, 16), (256, 576), (ROWS, COLS), (18560, 4464)):
        for threads in (1, 8):
            print(json.dumps(probe(rows, cols, threads)), flush=True)
