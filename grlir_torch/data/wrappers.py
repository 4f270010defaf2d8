"""Dataset wrappers (the port's copy of `grlir.data.wrappers`)."""

from __future__ import annotations


class RepeatDataset:
    """Virtual length multiplier."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, index):
        return self.dataset[index % len(self.dataset)]
