"""E-RAFT's correlation lookup: the bytes a training step's lookups must
move, and the least time they take at ``peaks.MEMORY_BYTES_S``.

Each of a step's ``iterations`` lookups samples the float32 pyramid (the
all-pairs correlation ``[B * h * w, 1, h, w]``, h x w = H/8 x W/8, and its
2x2 average pools) bilinearly at ``(2 r + 1)^2`` points of each level
around each pixel's coordinates.  Every pixel has its own correlation
maps, so no two pixels share a cell.

- Forward: of each level, the cells a pixel's window touches: the
  ``2 r + 2`` cells along each axis that ``2 r + 1`` bilinear taps span,
  centred where the pixel lies on that level (``i / 2^k``), cut to the
  level; the coordinates read (2 floats a pixel); the ``levels *
  (2 r + 1)^2`` float32 channels written.  At 256 x 256 that is ~220 of a
  pixel's 1,360 pyramid cells (~85 of level 0's 1,024, ~71 of level 1's
  256, ~47 of level 2's 64, all 16 of level 3).  The windows sit where
  the flow moves them; at the pixel grid is where the update starts, and
  a window moved further off the map reads fewer cells.
- Backward (the pyramid's gradient; the coordinates are detached): the
  output's gradient and the coordinates read, and each level's gradient
  written whole.  That write is compulsory: the lookup hands autograd the
  gradient of each level as a dense tensor of the level's shape, which
  the pools' and the correlation's backwards read whole, zero where no
  window reached.  The pyramid's values are not read: the gradient of a
  bilinear sample in its input needs only the weights.

Bytes bound both: a lookup does 8 flop a tap and corner, far under the
bytes' time.  The sizes are ``configs/eraft.json``'s: a metric reads only
its ``readers.Records``, which keeps no cell, so a cell of another
configuration at other sizes needs the reader to get its cell first.
"""
import json
from pathlib import Path

from . import peaks

CONFIG = Path(__file__).resolve().parents[1] / 'configs' / 'eraft.json'
# the profiler's names of the lookup's device ops (``F.grid_sample``)
KERNELS = {'fwd': ('grid_sampler_2d_kernel',),
           'bwd': ('grid_sampler_2d_backward_kernel',)}


def window_cells(n, level, radius):
    """Cells along one axis of ``level`` (``n >> level`` wide) that the
    windows of ``n`` pixels touch, summed over the pixels."""
    size = n >> level
    total = 0
    for i in range(n):
        lo = (i >> level) - radius
        hi = lo + 2 * radius + 1
        total += max(0, min(hi, size - 1) - max(lo, 0) + 1)
    return total


def lookup_work(batch, height, width, levels, radius, iterations):
    """``{'fwd': bound kwargs, 'bwd': ...}`` of one step's lookups."""
    h, w = height // 8, width // 8
    touched = sum(window_cells(h, k, radius) * window_cells(w, k, radius)
                  for k in range(levels))
    dense = sum((h >> k) * (w >> k) for k in range(levels)) * h * w
    pixels = batch * h * w
    coords = 4 * pixels * 2
    out = 4 * pixels * levels * (2 * radius + 1) ** 2
    return {'fwd': dict(nbytes=iterations * (4 * batch * touched + coords
                                             + out)),
            'bwd': dict(nbytes=iterations * (out + coords
                                             + 4 * batch * dense))}


def lookup_least_s(steps):
    """``{'fwd': s, 'bwd': s}``: the least time of ``steps`` steps'
    lookups, at ``configs/eraft.json``'s sizes."""
    config = json.loads(CONFIG.read_text())
    flags, sizes = config['flags'], config['model']
    work = lookup_work(flags['-mbs'], flags['--height'], flags['--width'],
                       sizes['corr_levels'], sizes['corr_radius'],
                       sizes['iterations'])
    return {d: steps * peaks.bound(**kw) for d, kw in work.items()}


def lookup_roofline(rec, direction):
    """The lookup's least time over the traced steps over its device time,
    in %; None where its kernels did not run."""
    spent = rec.trace.seconds(KERNELS[direction])
    if spent <= 0:
        return None
    return 100.0 * lookup_least_s(rec.trace.steps)[direction] / spent
