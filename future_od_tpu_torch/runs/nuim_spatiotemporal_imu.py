"""nuImages spatiotemporal + IMU, 500 ms horizon at 2 Hz (port of
runs/nuim_spatiotemporal_imu.py), on one CUDA card: frames [-2, -1, 0]
around the annotated keyframe, the two-stage curriculum, 400 epochs with
its own learning-rate schedule. Run it as a module from the repo root.
"""
from future_od_tpu_torch.data import nu_images
from future_od_tpu_torch.runs._helper import run_script, script_parser
from future_od_tpu_torch.runs._loader import get_nuim_loaders
from future_od_tpu_torch.runs.config import config

OFFSETS = [-2, -1, 0]


def lr_func(e: int) -> float:
    """20 warm-up epochs, then 1.0 to epoch 240, 0.5 to 360, 0.1 after."""
    return (e + 1) / (1 + 20) if e < 20 else 1.0 if e <= 240 else 0.5 if e <= 360 else 0.1


def build_parser():
    return script_parser(400)


def main(argv=None):
    """Parse `argv` (default: the command line), build the flagship and
    train it; returns the Trainer."""
    return run_script(__file__, argv, 400, config, get_nuim_loaders, OFFSETS,
                      nu_images.CATEGORY_DICT, lr_func=lr_func)


if __name__ == "__main__":
    main()
