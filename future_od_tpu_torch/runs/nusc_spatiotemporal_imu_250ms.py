"""nuScenes spatiotemporal + IMU, 250 ms horizon (port of
runs/nusc_spatiotemporal_imu_250ms.py), on one CUDA card: the 500 ms run's
curriculum at offsets [-0.5, -0.25, 0] s. Run it as a module from the repo
root (`python -m future_od_tpu_torch.runs.nusc_spatiotemporal_imu_250ms`).
"""
from future_od_tpu_torch.data import nu_scenes
from future_od_tpu_torch.runs._helper import run_script, script_parser
from future_od_tpu_torch.runs._loader import get_nusc_loaders
from future_od_tpu_torch.runs.config import config

OFFSETS = [-0.5, -0.25, 0]


def build_parser():
    return script_parser(160)


def main(argv=None):
    """Parse `argv` (default: the command line), build the flagship and
    train it; returns the Trainer."""
    return run_script(__file__, argv, 160, config, get_nusc_loaders, OFFSETS,
                      nu_scenes.CATEGORY_DICT)


if __name__ == "__main__":
    main()
