"""Simulated DVS recording: a textured scene seen by a drifting camera.

A frozen copy of the translate motion of
``dvs_of_training_framework_tpu_torch/data/synthetic.py`` (``make_scene``,
``camera_path``, ``window``, ``simulate_translate``, ``_EventAccumulator``,
themselves copies of ``scripts/make_synthetic_mvsec.py``), so that a change
to the port cannot move the benchmark's traffic.  Two departures, both for
set-up time: a blob is summed only within four of its standard deviations
of its centre (beyond them it adds under 3.4e-4 of its amplitude), and the
recording keeps no ground-truth flow, which training does not read.
"""
import numpy as np

H, W = 260, 346          # DAVIS346 sensor, as MVSEC
FRAME_DT = 0.05          # 20 frames a second, MVSEC's GT cadence
FINE_STEPS = 10          # event-simulation sub-steps a frame
THRESHOLD = 0.18         # contrast threshold, log-intensity units
EPOCH_BASE = 1000.0
SCENE = (720, 1024)


def make_scene(rng, shape=SCENE, num_blobs=260):
    """Smooth random intensity texture with strong local gradients,
    0..255."""
    img = np.zeros(shape, np.float64)
    for _ in range(num_blobs):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        sigma = rng.uniform(4, 30)
        amp = rng.uniform(30, 140) * rng.choice([-1, 1])
        r = int(np.ceil(4 * sigma))
        y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, shape[0])
        x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, shape[1])
        ys = np.arange(y0, y1)[:, None]
        xs = np.arange(x0, x1)[None, :]
        img[y0:y1, x0:x1] += amp * np.exp(
            -((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sigma ** 2))
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img


def camera_path(t, scene_shape, seed_phase=0.0, speed=1.0):
    """Integer camera-window position at times ``t`` (sinusoidal drift;
    ``speed`` 1.0 peaks near 9 px a frame)."""
    cy = (scene_shape[0] - H) / 2
    cx = (scene_shape[1] - W) / 2
    ay, ax = (cy - 8) * speed, (cx - 8) * speed
    py = cy + ay * np.sin(2 * np.pi * t / 7.3 + seed_phase + 0.4)
    px = cx + ax * np.sin(2 * np.pi * t / 11.7 + seed_phase)
    return np.rint(py).astype(int), np.rint(px).astype(int)


def window(scene, py, px):
    return scene[py:py + H, px:px + W]


class EventAccumulator:
    """Per-pixel reference-crossing event generator."""

    def __init__(self, rng):
        self.rng = rng
        self.ev = []

    def step(self, ref, cur, t0, t1):
        """Events for the log-intensity move ``ref -> cur`` in ``(t0, t1]``;
        advances ``ref`` in place by the emitted threshold counts."""
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
        """``[N, 4]`` float64 rows ``(x, y, t, p)`` in time order."""
        x = np.concatenate([e[0] for e in self.ev]).astype(np.float64)
        y = np.concatenate([e[1] for e in self.ev]).astype(np.float64)
        t = np.concatenate([e[2] for e in self.ev])
        p = np.concatenate([e[3] for e in self.ev]).astype(np.float64)
        order = np.argsort(t, kind='stable')
        return np.stack([x[order], y[order], t[order], p[order]], axis=1)


def simulate(rng, duration, seed_phase, speed=1.0):
    """``(events [N, 4], frames uint8 [F, H, W], frame_ts [F])`` of a
    ``duration``-second recording of a random scene."""
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
    acc = EventAccumulator(rng)
    for k in range(1, fine_t.size):
        acc.step(ref, window(log_scene, pys[k], pxs[k]), fine_t[k - 1],
                 fine_t[k])
    return acc.finish(), frames, frame_ts
