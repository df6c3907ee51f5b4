"""Synthetic bench batches: a simulated DVS recording cut into collated
batches of the benchmark's shape (batch 8, 256x256, up to 2^17 events).

The port's copy of ``_simulated_stream`` and ``make_collated`` of the
repo's root ``bench.py`` (with the shape constants they read), and of the
brightness-change simulator they call, ``simulate_sequence`` of
``scripts/make_synthetic_mvsec.py`` with what its ``translate`` motion
uses (``make_scene``, ``camera_path``, ``window``, ``simulate_translate``,
``_EventAccumulator``).  The ``varied`` motion model is not copied:
nothing here calls it, and ``simulate_sequence`` raises for it.  The
originals' code is unchanged otherwise; this module needs numpy alone.

``make_collated(rng, sample_offset)`` returns the host-collated batch
dict that ``data.pad_batch`` pads; the recording is simulated once, from
its own fixed seed, on the first call.
"""
import os

import numpy as np

# bench.py
BATCH_SIZE = int(os.environ.get('BENCH_BATCH', 8))
N_EVENTS = int(os.environ.get('BENCH_EVENTS', 2 ** 17))
CAPACITY = N_EVENTS
IMSIZE = (256, 256)

# scripts/make_synthetic_mvsec.py
H, W = 260, 346
FRAME_DT = 0.05          # 20 fps, like MVSEC GT cadence
FINE_STEPS = 10          # event-simulation sub-steps per frame
THRESHOLD = 0.18         # DVS contrast threshold (log-intensity units)
EPOCH_BASE = 1000.0      # fake epoch offset (exercises info alignment)
SCENE = (720, 1024)


def make_scene(rng, shape=SCENE, num_blobs=260):
    """Smooth random log-intensity texture with strong local gradients."""
    img = np.zeros(shape, np.float64)
    ys, xs = np.mgrid[0:shape[0], 0:shape[1]]
    for _ in range(num_blobs):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        sigma = rng.uniform(4, 30)
        amp = rng.uniform(30, 140) * rng.choice([-1, 1])
        img += amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2)
                            / (2 * sigma ** 2))
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img


def camera_path(t, scene_shape, seed_phase=0.0, speed=1.0):
    """Integer camera-window position at time(s) t (sinusoidal drift).

    ``speed`` scales the drift amplitudes: 1.0 gives ~9 px/frame peak
    motion (the hard round-2 setting); ~0.35 gives MVSEC-outdoor-like
    1-5 px/frame (the round-3 accuracy protocol).
    """
    cy = (scene_shape[0] - H) / 2
    cx = (scene_shape[1] - W) / 2
    ay, ax_ = (cy - 8) * speed, (cx - 8) * speed
    py = cy + ay * np.sin(2 * np.pi * t / 7.3 + seed_phase + 0.4)
    px = cx + ax_ * np.sin(2 * np.pi * t / 11.7 + seed_phase)
    return np.rint(py).astype(int), np.rint(px).astype(int)


def window(scene, py, px):
    return scene[py:py + H, px:px + W]


def simulate_translate(rng, duration, seed_phase, speed=1.0):
    """Round 2-3 integer-translation simulation (constant GT per pair)."""
    scene = make_scene(rng)
    log_scene = np.log1p(scene)
    n_frames = int(round(duration / FRAME_DT)) + 1
    frame_ts = EPOCH_BASE + np.arange(n_frames) * FRAME_DT

    fine_t = EPOCH_BASE + np.arange((n_frames - 1) * FINE_STEPS + 1) \
        * (FRAME_DT / FINE_STEPS)
    pys, pxs = camera_path(fine_t - EPOCH_BASE, scene.shape, seed_phase,
                           speed)

    frames = np.stack([
        window(scene, pys[i * FINE_STEPS], pxs[i * FINE_STEPS])
        for i in range(n_frames)]).astype(np.uint8)

    ref = window(log_scene, pys[0], pxs[0]).copy()
    acc = _EventAccumulator(rng)
    for k in range(1, fine_t.size):
        cur = window(log_scene, pys[k], pxs[k])
        acc.step(ref, cur, fine_t[k - 1], fine_t[k])
    events = acc.finish()

    # camera moves by dp; image content shifts by -dp
    f_py = pys[::FINE_STEPS]
    f_px = pxs[::FINE_STEPS]
    gt_u = -(np.diff(f_px)).astype(np.float32)      # x displacement
    gt_v = -(np.diff(f_py)).astype(np.float32)
    gt = {
        'timestamps': frame_ts,
        'x_flow_dist': np.broadcast_to(
            gt_u[:, None, None], (gt_u.size, H, W)).astype(np.float32),
        'y_flow_dist': np.broadcast_to(
            gt_v[:, None, None], (gt_v.size, H, W)).astype(np.float32),
    }
    return events, frames, frame_ts, gt


class _EventAccumulator:
    """Per-pixel reference-crossing event generator (shared by both modes)."""

    def __init__(self, rng):
        self.rng = rng
        self.ev = []

    def step(self, ref, cur, t0, t1):
        """Emit events for the log-intensity move ref -> cur in (t0, t1].

        Mutates ``ref`` in place (the per-pixel reference level advances by
        the emitted threshold counts, like a real DVS pixel).
        """
        delta = cur - ref
        n_ev = np.floor(np.abs(delta) / THRESHOLD).astype(np.int32)
        np.minimum(n_ev, 3, out=n_ev)  # refractory cap
        yy, xx = np.nonzero(n_ev)
        if yy.size:
            counts = n_ev[yy, xx]
            pol = np.sign(delta[yy, xx])
            x_rep = np.repeat(xx, counts)
            y_rep = np.repeat(yy, counts)
            p_rep = np.repeat(pol, counts)
            t_rep = self.rng.uniform(t0, t1, size=x_rep.size)
            self.ev.append((x_rep, y_rep, t_rep, p_rep))
            ref[yy, xx] += np.sign(delta[yy, xx]) * counts * THRESHOLD

    def finish(self):
        x = np.concatenate([e[0] for e in self.ev]).astype(np.float64)
        y = np.concatenate([e[1] for e in self.ev]).astype(np.float64)
        t = np.concatenate([e[2] for e in self.ev])
        p = np.concatenate([e[3] for e in self.ev]).astype(np.float64)
        order = np.argsort(t, kind='stable')
        return np.stack([x[order], y[order], t[order], p[order]], axis=1)


def simulate_sequence(rng, duration, seed_phase, speed=1.0,
                      motion='translate'):
    if motion != 'translate':
        raise NotImplementedError(f'motion {motion!r}: only the translate '
                                  'model is copied here')
    return simulate_translate(rng, duration, seed_phase, speed)


_SIM = None  # (events [N,4], frames, frame_ts) from the DVS simulator


def _simulated_stream(rng):
    """Short simulated-DVS recording: spatially-clustered (edge) events.

    Real MVSEC events cluster on moving edges; uniform random events
    change scatter/one-hot behaviour, so the bench draws samples from the
    same brightness-change simulator that generates the synthetic MVSEC
    dataset (scripts/make_synthetic_mvsec.py).
    """
    global _SIM
    if _SIM is None:
        _SIM = simulate_sequence(np.random.default_rng(11), 3.0, 0.7)
    return _SIM


def make_collated(rng, sample_offset=0):
    """Host-collated ragged batch dict (pre-padding), bench workload."""
    H, W = IMSIZE
    events, frames, frame_ts, _gt = _simulated_stream(rng)
    n_windows = frame_ts.size - 1
    xs, ys, ts, ps, eis, sis = [], [], [], [], [], []
    images = []
    timestamps = []
    fh, fw = frames.shape[1:3]
    oy, ox = (fh - H) // 2, (fw - W) // 2
    per_sample = max(N_EVENTS // BATCH_SIZE, 1)
    for b in range(BATCH_SIZE):
        w = (sample_offset + b) % n_windows
        lo, hi = np.searchsorted(events[:, 2],
                                 [frame_ts[w], frame_ts[w + 1]])
        sel = events[lo:hi]
        # central 256x256 crop (drops out-of-box events, like EventCrop)
        keep = ((sel[:, 0] >= ox) & (sel[:, 0] < ox + W)
                & (sel[:, 1] >= oy) & (sel[:, 1] < oy + H))
        sel = sel[keep][:per_sample]
        xs.append(sel[:, 0] - ox)
        ys.append(sel[:, 1] - oy)
        ts.append((sel[:, 2] - frame_ts[w]).astype(np.float32))
        ps.append(sel[:, 3])
        eis.append(np.zeros(sel.shape[0], np.int64))
        sis.append(np.full(sel.shape[0], b, np.int64))
        images.append(frames[w, oy:oy + H, ox:ox + W])
        images.append(frames[w + 1, oy:oy + H, ox:ox + W])
        timestamps.extend([0.0, frame_ts[w + 1] - frame_ts[w]])
    ev = {
        'x': np.concatenate(xs),
        'y': np.concatenate(ys),
        'timestamp': np.concatenate(ts),
        'polarity': np.concatenate(ps),
        'element_index': np.concatenate(eis),
        'sample_index': np.concatenate(sis),
    }
    return {
        'events': ev,
        'timestamps': np.asarray(timestamps, np.float32),
        'sample_idx': np.repeat(np.arange(BATCH_SIZE), 2).astype(np.int32),
        'images': np.stack(images)[:, None].astype(np.float32),
        'size': BATCH_SIZE,
    }
