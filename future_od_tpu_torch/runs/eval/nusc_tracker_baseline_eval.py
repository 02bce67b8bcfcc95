"""The non-learned tracker-baseline eval (port of
runs/eval/nusc_tracker_baseline_eval.py), on one CUDA card.

Single-frame detections of the two past frames are assigned by the exact
LAP and linearly extrapolated to the future frame by the host-side
`TrackerFuturePredictor`; AP is scored against the future frame's
annotations. The detector is trained at L=1 by runs/nuim_single_frame.py:
its parameters are `build_single_frame`'s, so that script's final
checkpoint loads directly. FUTURE_OD_TRACKER_DIM_EXTRAPOLATION picks the
box-size extrapolation ("linear", "percentual", "average"; unset: none).
Run it as a module from the repo root.
"""
import os

from future_od_tpu_torch.models.build import build_tracker_baseline
from future_od_tpu_torch.models.tracker import TrackerFuturePredictor
from future_od_tpu_torch.runs.eval._common import run_eval

OFFSETS = [-1.0, -0.5, 0]


def main(argv=None):
    dim_mode = os.environ.get("FUTURE_OD_TRACKER_DIM_EXTRAPOLATION") or None
    return run_eval(
        __file__, "nusc", offsets=OFFSETS,
        default_checkpoint="nuim_single_frame_final",
        filter_offsets=OFFSETS, argv=argv,
        model_builder=lambda args, detr_args: build_tracker_baseline(detr_args),
        tracker=TrackerFuturePredictor(dim_extrapolation=dim_mode),
    )


if __name__ == "__main__":
    main()
