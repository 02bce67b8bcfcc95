"""Run scripts of the port (port of the repo's `runs/`): the flagship's
training script and its helpers. Run a script as a module, e.g.
`python -m future_od_tpu_torch.runs.nusc_spatiotemporal_imu_500ms --help`."""
