"""The port's kernel-study tools (ports of the JAX repo's tools/bench_*.py).

Run each on the card as `python -m future_od_tpu_torch.tools.<name>`, or
with `--check` on the CPU at tiny shapes through the kernels' plain versions.
"""
