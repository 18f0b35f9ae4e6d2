"""Multi-device runs (mirror of `sph_sm_monodomain_tpu.parallel`): the
particle-sharded all-gather step, unfused (`sharded_step.make_sharded_step`)
and fused on a slab of sorted query rows (`make_sharded_step_fused`), and
the slab-ownership halo-exchange step with particle migration
(`halo_step.make_halo_step`), on `torch.distributed` with one process per
rank (`comm`: gloo on the CPU, NCCL with a card a rank, gloo through host
copies for ranks that share a card). Their simulates run on the run loop
of models/scan.py, graphed over NCCL (`sharded_step.run_loop`).
"""
