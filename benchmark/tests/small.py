"""A cell of the manifest cut to a size a CPU test run holds: the
reference app's 4,796-particle biceps cloud (`biceps_1`) and a few steps,
with the cell's own limits."""

from __future__ import annotations

from benchmark.common import cell_files, load_manifest

SCENE, CLOUD, PARTICLES = "biceps_1", "assets/biceps_simple_out_1.csv", 4796


def small_cell(workload: str):
    """(manifest, (cell, configuration, traffic, checks)) of `workload`
    on the small cloud: a 6-step protocol (stim off before step 3, 2-step
    chunks) or a 5-step wave."""
    man = load_manifest()
    cell, conf, traffic, checks = cell_files(man, workload)
    conf = dict(conf, scene=SCENE, cloud=CLOUD, particles=PARTICLES,
                replicate=1, clusters=1,
                physics=dict(conf["physics"], world_size=[1.5, 1.5, 1.5]))
    if traffic["driver"] == "protocol":
        traffic = dict(traffic, steps=6, stim_off=3, chunk=2)
    else:
        traffic = dict(traffic, steps=5)
    return man, (cell, conf, traffic, checks)
