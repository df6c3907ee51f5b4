"""The one traffic generator: a pool of host-collated training batches.

A traffic file (``traffic/<name>.json``) holds parameters only:

- ``stream``: ``duration_s`` and ``speed`` of the simulated recording
  (``simulator.simulate``), its scene and drift phase drawn from the seed;
- ``events_per_element_cap``: events a sample element keeps, the first
  in time order of its frame window inside its crop (the collation of
  ``data/synthetic.py`` ``make_collated``, the port's copy of
  ``bench.py``'s);
- ``pool_windows``: distinct batches in the pool, in device-queue windows.

The configuration gives the shapes: batch size, crop, elements a sample.
Every sample draws its frame window and its crop from the seed, so the
batches of a pool all differ.  A batch is the dict that the port's
collation gives (``data/collate.py``): ragged ``events``, ``timestamps``
and ``images`` of each element boundary, ``sample_idx``, ``size``; event
and frame times are seconds from the sample's first frame.
"""
import numpy as np

from . import simulator


def stream(traffic, seed):
    """The simulated recording of ``seed``: ``(events, frames,
    frame_ts)``."""
    rng = np.random.default_rng([seed, 0])
    params = traffic['stream']
    return simulator.simulate(rng, params['duration_s'],
                              rng.uniform(0.0, 2 * np.pi),
                              params.get('speed', 1.0))


def make_pool(traffic, seed, batch_size, shape, elements, window):
    """``pool_windows * window`` collated batches of ``batch_size``
    samples of ``elements`` consecutive frame windows, cropped to
    ``shape``."""
    events, frames, frame_ts = stream(traffic, seed)
    rng = np.random.default_rng([seed, 1])
    H, W = shape
    fh, fw = frames.shape[1:]
    cap = int(traffic['events_per_element_cap'])
    n_windows = frame_ts.size - 1
    bounds = np.searchsorted(events[:, 2], frame_ts)
    pool = []
    for _ in range(int(traffic['pool_windows']) * window):
        cols = {k: [] for k in ('x', 'y', 'timestamp', 'polarity',
                                'element_index', 'sample_index')}
        images, timestamps = [], []
        for b in range(batch_size):
            w = int(rng.integers(0, n_windows - elements + 1))
            oy = int(rng.integers(0, fh - H + 1))
            ox = int(rng.integers(0, fw - W + 1))
            for e in range(elements):
                sel = events[bounds[w + e]:bounds[w + e + 1]]
                keep = ((sel[:, 0] >= ox) & (sel[:, 0] < ox + W)
                        & (sel[:, 1] >= oy) & (sel[:, 1] < oy + H))
                sel = sel[keep][:cap]
                cols['x'].append((sel[:, 0] - ox).astype(np.int32))
                cols['y'].append((sel[:, 1] - oy).astype(np.int32))
                cols['timestamp'].append(
                    (sel[:, 2] - frame_ts[w]).astype(np.float32))
                cols['polarity'].append(sel[:, 3].astype(np.float32))
                cols['element_index'].append(
                    np.full(sel.shape[0], e, np.int32))
                cols['sample_index'].append(
                    np.full(sel.shape[0], b, np.int64))
            for e in range(elements + 1):
                images.append(frames[w + e, oy:oy + H, ox:ox + W])
                timestamps.append(frame_ts[w + e] - frame_ts[w])
        pool.append({
            'events': {k: np.concatenate(v) for k, v in cols.items()},
            'timestamps': np.asarray(timestamps, np.float32),
            'sample_idx': np.repeat(np.arange(batch_size),
                                    elements + 1).astype(np.int64),
            'images': np.stack(images)[:, None].astype(np.float32),
            'size': batch_size,
        })
    return pool


def num_events(batch):
    """Real events of a collated batch."""
    return int(batch['events']['x'].size)
