"""What a per-layer metric's reader (`metrics/<name>.py`) reads: the cell,
its traced window (`trace.Timeline`) and what the harness counted in it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from h100_bench import trace as tr


@dataclass
class Context:
    cell: object
    timeline: Optional[tr.Timeline]
    counts: dict

    @property
    def kind(self) -> str:
        return self.cell.kind

    @property
    def model(self) -> dict:
        return self.cell.model()

    @property
    def dtype(self) -> str:
        return self.cell.config["dtype"]

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def on_device(self) -> bool:
        """Whether the window has device activity to read."""
        return self.timeline is not None and self.timeline.busy_s > 0
