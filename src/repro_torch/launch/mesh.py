"""The production grids (the reference's ``launch/mesh.py``): functions,
so importing touches no device and no process group."""
from __future__ import annotations

from repro_torch.sharding.grid import RecordingGrid

#: the dry run's grid names: one card, one pod, two pods
GRID_NAMES = ("1", "16x16", "2x16x16")


def make_production_grid(*, multi_pod: bool = False,
                         rank: int = 0) -> RecordingGrid:
    """16 x 16 = 256 ranks of one pod on ("data", "model"); two pods add
    "pod" in front, (2, 16, 16). A recording grid: the dry run's stand-in
    for that many cards, placed at ``rank``."""
    if multi_pod:
        return RecordingGrid(("pod", "data", "model"), (2, 16, 16), rank)
    return RecordingGrid(("data", "model"), (16, 16), rank)


def grid_for(name: str):
    """The grid a dry-run grid name stands for: None for ``"1"`` (one
    card, no collective), else :func:`make_production_grid`'s."""
    if name not in GRID_NAMES:
        raise ValueError(f"unknown grid {name!r}; expected {GRID_NAMES}")
    return None if name == "1" else make_production_grid(
        multi_pod=name == "2x16x16")


def client_axes(grid) -> tuple:
    """The grid axes that carry the client-parallel dimension."""
    return grid.client_axes


def num_clients_for(grid) -> int:
    """The SCALA client count of ``grid``: its ``data`` size (times its
    ``pod`` size); None (one card) takes one pod's, 16."""
    if grid is None:
        grid = make_production_grid()
    n = grid.shape.get("data", 1)
    return n * grid.shape.get("pod", 1)
