"""nuScenes spatiotemporal + IMU, previous-frame horizon (about 50-100 ms; port
of runs/nusc_spatiotemporal_imu_prevframe.py), on one CUDA card: the 500 ms
run's curriculum at offsets ["prev", "prev", 0], with `encode_offset`. The
flagship's core encodes no temporal positions (`no_temporal_pos`), so the
offsets do not reach its output. Run it as a module from the repo root.
"""
from future_od_tpu_torch.data import nu_scenes
from future_od_tpu_torch.runs._helper import run_script, script_parser
from future_od_tpu_torch.runs._loader import get_nusc_loaders
from future_od_tpu_torch.runs.config import config

OFFSETS = ["prev", "prev", 0]


def build_parser():
    return script_parser(160)


def main(argv=None):
    """Parse `argv` (default: the command line), build the flagship and
    train it; returns the Trainer."""
    return run_script(__file__, argv, 160, config, get_nusc_loaders, OFFSETS,
                      nu_scenes.CATEGORY_DICT,
                      encode_offset=True)


if __name__ == "__main__":
    main()
