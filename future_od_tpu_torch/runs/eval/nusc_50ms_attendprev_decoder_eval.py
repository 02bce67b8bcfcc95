"""nuScenes 50 ms eval (port of runs/eval/nusc_50ms_attendprev_decoder_eval.py):
the shared ~83 ms checkpoint, with encoded temporal offsets."""
from future_od_tpu_torch.runs.eval._common import run_eval


def main(argv=None):
    return run_eval(
        __file__, "nusc", offsets=["prev", -0.05, 0],
        default_checkpoint="w6_nusc_83ms_attendprev_decoder",
        encode_offset=True, filter_offsets=["prev", -0.05, 0], argv=argv,
    )


if __name__ == "__main__":
    main()
