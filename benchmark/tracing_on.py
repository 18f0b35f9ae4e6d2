"""One benchmark run with the package's program tracing on throughout
(sph_sm_monodomain_tpu_torch/utils/tracing.py): set-up, the window and the
check.

    python3 -m benchmark.tracing_on --workload <name> --seed <n> \
        --seconds <s>

from the root of a checkout on a machine with an NVIDIA GPU. Arguments,
standard error and the result line are benchmark.run's with --trace 0, and
the last line on standard error counts the spans and the counters that
moved. Its rate against benchmark.run's on the same seed, in turns on one
card, is what tracing costs while it is on. It is no cell: the benchmark's
own runs keep tracing off.
"""

from __future__ import annotations

import sys

from . import run


def main(argv=None) -> int:
    run._environment()
    from sph_sm_monodomain_tpu_torch.utils import tracing
    with tracing.enabled():
        rc = run.main(argv)
        moved = {k: v for k, v in tracing.snapshot().items() if v}
        print(f"tracing on: {len(tracing.spans())} spans; counters {moved}",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
