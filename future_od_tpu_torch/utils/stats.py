"""Running statistics (port of future_od_tpu/utils/stats.py)."""
from __future__ import annotations


class AverageMeter:
    """The average and the current value, with one average a finished epoch
    in `history`."""

    def __init__(self):
        self.clear()

    def reset(self):
        self.avg = 0
        self.val = 0
        self.sum = 0
        self.count = 0

    def clear(self):
        self.reset()
        self.history = []

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count > 0 else float("nan")

    def new_epoch(self):
        self.history.append(self.avg)
        self.reset()

    def state_dict(self):
        return {
            "avg": self.avg, "val": self.val, "sum": self.sum,
            "count": self.count, "history": list(self.history),
        }

    def load_state_dict(self, d):
        self.avg, self.val = d["avg"], d["val"]
        self.sum, self.count = d["sum"], d["count"]
        self.history = list(d["history"])
