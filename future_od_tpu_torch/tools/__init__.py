"""The port's tools (ports of the JAX repo's tools/*.py): the kernel
studies (bench_*.py) and the learning-loop checks (the overfit probes,
synthetic_convergence, matcher_drift_branched, quant_ap_check and
noise_ap_check).

Run each on the card as `python -m future_od_tpu_torch.tools.<name>`, or
with `--check` on the CPU at a tiny size (the kernels through their plain
versions).
"""
