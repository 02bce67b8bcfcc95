"""nuImages 500 ms eval (port of runs/eval/nuim_spatiotemporal_imu_eval.py)."""
from future_od_tpu_torch.runs.eval._common import run_eval


def main(argv=None):
    return run_eval(
        __file__, "nuim", offsets=[-2, -1, 0],
        default_checkpoint="w6_nuim_spatiotemporal_imu", argv=argv,
    )


if __name__ == "__main__":
    main()
