"""nuScenes 250 ms eval (port of runs/eval/nusc_250ms_attendprev_decoder_eval.py)."""
from future_od_tpu_torch.runs.eval._common import run_eval


def main(argv=None):
    return run_eval(
        __file__, "nusc", offsets=[-0.5, -0.25, 0],
        default_checkpoint="w6_nusc_250ms_attendprev_decoder",
        filter_offsets=[-0.5, -0.25, 0], argv=argv,
    )


if __name__ == "__main__":
    main()
