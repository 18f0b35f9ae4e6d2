"""The superseded v1 / v2 fused-step generations (mirror of
`sph_sm_monodomain_tpu.ablation`'s sweeps and steps): kept as measured
ablation baselines, reached through `step_fused(impl="v1" | "v2")`, which
imports them lazily. Nothing else in the package imports this subpackage.
"""
