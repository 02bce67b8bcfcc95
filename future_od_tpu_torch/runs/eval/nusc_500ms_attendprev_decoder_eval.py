"""nuScenes 500 ms eval (port of runs/eval/nusc_500ms_attendprev_decoder_eval.py)."""
from future_od_tpu_torch.runs.eval._common import run_eval


def main(argv=None):
    return run_eval(
        __file__, "nusc", offsets=[-1.0, -0.5, 0],
        default_checkpoint="w6_nusc_500ms_attendprev_decoder",
        filter_offsets=[-1.0, -0.5, 0], argv=argv,
    )


if __name__ == "__main__":
    main()
