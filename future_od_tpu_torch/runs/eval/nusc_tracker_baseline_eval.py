"""The non-learned tracker-baseline eval (runs/eval/nusc_tracker_baseline_eval.py):
not ported yet. Its model (`build_tracker_baseline`), the host-side
`TrackerFuturePredictor` and the tracker eval step are ROADMAP.md Queue 1
item 3."""


def main(argv=None):
    raise NotImplementedError(
        "the tracker baseline is not ported yet (ROADMAP.md Queue 1 item 3)")


if __name__ == "__main__":
    main()
