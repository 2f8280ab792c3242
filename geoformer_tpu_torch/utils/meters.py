"""Running meters for train loops (reference: util/utils.py AverageMeter).

The port's copy of geoformer_tpu/utils/meters.py."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class DictAverageMeter:
    """Meter over a dict of (value, n) pairs, as the reference logs losses."""

    def __init__(self):
        self.meters: dict[str, AverageMeter] = {}

    def update(self, d: dict):
        for k, v in d.items():
            if isinstance(v, tuple):
                val, n = v
            else:
                val, n = v, 1
            self.meters.setdefault(k, AverageMeter()).update(val, n)

    def averages(self) -> dict:
        return {k: m.avg for k, m in self.meters.items()}
