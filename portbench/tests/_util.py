"""Shared set-up of the benchmark's tests: the repository root on the path,
one host thread, and a cell cut to a size the host runs in seconds."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)

from portbench import core  # noqa: E402


def small_cell(name: str, root: str = ROOT, batch: int = 12, pool: int = 2,
               rows: int = 6):
    """The cell ``name`` of ``root``'s BENCHMARK.json (or of its held-out
    cells) at a host size."""
    cell = core.Cell(core.read_bench(root, held_out=True), name, root)
    cell.traffic.update(batch=batch, pool=pool)
    cell.check.update(rows_per_batch=rows, trace_calls=1)
    return cell
