"""Synthetic DVS data: the simulated MVSEC-format recordings of
``scripts/make_synthetic_mvsec.py``, and bench batches cut from one.

The port's copy of the simulator and writers of
``scripts/make_synthetic_mvsec.py``: ``simulate_sequence`` with both
motion models (``translate``: ``make_scene``, ``camera_path``, ``window``,
``simulate_translate``, ``_EventAccumulator``; ``varied``:
``make_foreground``, ``_SimilarityPath``, ``_sensor_grid``, ``_sample``,
``simulate_varied``), ``write_sequence``, and ``write_info``, the info
writer of its ``main``.  The writers go through ``store.open_file``, so
they write the npy store; ``_sample`` imports scipy inside, and the rest
needs numpy alone.  Also the port's copy of ``_simulated_stream`` and
``make_collated`` of the repo's root ``bench.py`` (with the shape
constants they read).  The originals' code is unchanged otherwise.

``make_collated(rng, sample_offset)`` returns the host-collated batch
dict that ``data.pad_batch`` pads; the recording is simulated once, from
its own fixed seed, on the first call.
"""
import os

import numpy as np

from . import store

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


def make_foreground(rng, shape=SCENE, num_objects=28):
    """Textured opaque blobs (alpha mask) on a transparent plane."""
    tex = make_scene(rng, shape, num_blobs=200)
    alpha = np.zeros(shape, np.float64)
    ys, xs = np.mgrid[0:shape[0], 0:shape[1]]
    for _ in range(num_objects):
        cy = rng.uniform(0.15 * shape[0], 0.85 * shape[0])
        cx = rng.uniform(0.15 * shape[1], 0.85 * shape[1])
        ry = rng.uniform(14, 52)
        rx = rng.uniform(14, 52)
        # superellipse -> crisp but not axis-aligned-square boundaries
        d = (np.abs((ys - cy) / ry) ** 2.5
             + np.abs((xs - cx) / rx) ** 2.5)
        alpha[d <= 1.0] = 1.0
    return tex, alpha


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


class _SimilarityPath:
    """Time-varying 2-D similarity transform sensor->scene, as complex maps.

    A_t(z) = C_scene + T(t) + m(t) * (z - c_sensor),   m = s * e^{i theta}
    with z = x + i y in sensor pixel coordinates.
    """

    def __init__(self, t_amp, t_periods, t_phases, rot_amp, rot_period,
                 rot_phase, zoom_amp, zoom_period, zoom_phase):
        self.t_amp = t_amp            # (ty_amp, tx_amp)
        self.t_periods = t_periods    # (py, px)
        self.t_phases = t_phases
        self.rot = (rot_amp, rot_period, rot_phase)
        self.zoom = (zoom_amp, zoom_period, zoom_phase)
        self.c_sensor = complex((W - 1) / 2, (H - 1) / 2)
        self.c_scene = complex((SCENE[1] - 1) / 2, (SCENE[0] - 1) / 2)

    def translation(self, t):
        ty = self.t_amp[0] * np.sin(2 * np.pi * t / self.t_periods[0]
                                    + self.t_phases[0])
        tx = self.t_amp[1] * np.sin(2 * np.pi * t / self.t_periods[1]
                                    + self.t_phases[1])
        return tx + 1j * ty

    def multiplier(self, t):
        amp, period, phase = self.rot
        theta = amp * np.sin(2 * np.pi * t / period + phase)
        zamp, zperiod, zphase = self.zoom
        log_s = zamp * np.sin(2 * np.pi * t / zperiod + zphase)
        return np.exp(log_s) * np.exp(1j * theta)

    def scene_coords(self, t, grid_z):
        """Sensor grid -> scene (row, col) float coords at time t."""
        zc = (self.c_scene + self.translation(t)
              + self.multiplier(t) * (grid_z - self.c_sensor))
        return zc.imag, zc.real   # (rows, cols)

    def flow(self, t0, t1, grid_z):
        """Exact displacement field t0 -> t1 at sensor pixels ``grid_z``."""
        m0, m1 = self.multiplier(t0), self.multiplier(t1)
        d = (self.translation(t0) - self.translation(t1)
             + m0 * (grid_z - self.c_sensor))
        z1 = self.c_sensor + d / m1
        f = z1 - grid_z
        return f.real.astype(np.float32), f.imag.astype(np.float32)


def _sensor_grid():
    ys, xs = np.mgrid[0:H, 0:W]
    return xs + 1j * ys


def _sample(plane, rows, cols):
    from scipy.ndimage import map_coordinates
    return map_coordinates(plane, [rows, cols], order=1, mode='nearest')


def simulate_varied(rng, duration, seed_phase, speed=1.0):
    """Similarity-camera + parallax simulation with exact flow-field GT.

    ``speed`` scales translation amplitude like the translate mode; the
    rotation/zoom amplitudes are fixed (chosen for 1-3 px of cross-frame
    flow variation across the 256x256 eval crop at 20 fps).
    """
    bg = make_scene(rng)
    fg_tex, fg_alpha = make_foreground(rng)
    grid_z = _sensor_grid()

    bg_path = _SimilarityPath(
        t_amp=(220 * speed, 330 * speed), t_periods=(7.3, 11.7),
        t_phases=(seed_phase + 0.4, seed_phase),
        rot_amp=0.35, rot_period=7.9, rot_phase=seed_phase + 1.3,
        zoom_amp=0.12, zoom_period=5.3, zoom_phase=seed_phase + 2.6)
    # closer layer: independent drift (-> relative motion at occlusions),
    # the SAME roll (in-plane rotation is depth-independent), doubled zoom
    # response (forward motion scales with inverse depth)
    fg_path = _SimilarityPath(
        t_amp=(300 * speed, 430 * speed), t_periods=(6.1, 9.4),
        t_phases=(seed_phase + 3.1, seed_phase + 1.7),
        rot_amp=0.35, rot_period=7.9, rot_phase=seed_phase + 1.3,
        zoom_amp=0.24, zoom_period=5.3, zoom_phase=seed_phase + 2.6)

    def render(t):
        """Composite intensity + foreground visibility at time t."""
        br, bc = bg_path.scene_coords(t, grid_z)
        fr, fc = fg_path.scene_coords(t, grid_z)
        bg_val = _sample(bg, br, bc)
        fg_val = _sample(fg_tex, fr, fc)
        vis = _sample(fg_alpha, fr, fc) > 0.5
        return np.where(vis, fg_val, bg_val), vis

    n_frames = int(round(duration / FRAME_DT)) + 1
    frame_ts = EPOCH_BASE + np.arange(n_frames) * FRAME_DT
    fine_dt = FRAME_DT / FINE_STEPS
    n_fine = (n_frames - 1) * FINE_STEPS + 1

    frames = np.empty((n_frames, H, W), np.uint8)
    fg_vis = np.empty((n_frames, H, W), bool)

    img0, vis0 = render(0.0)
    frames[0] = np.clip(img0, 0, 255).astype(np.uint8)
    fg_vis[0] = vis0
    ref = np.log1p(np.maximum(img0, 0.0))
    acc = _EventAccumulator(rng)
    for k in range(1, n_fine):
        t = k * fine_dt
        img, vis = render(t)
        cur = np.log1p(np.maximum(img, 0.0))
        acc.step(ref, cur, EPOCH_BASE + (k - 1) * fine_dt, EPOCH_BASE + t)
        if k % FINE_STEPS == 0:
            i = k // FINE_STEPS
            frames[i] = np.clip(img, 0, 255).astype(np.uint8)
            fg_vis[i] = vis
    events = acc.finish()

    # exact per-pixel GT: the visible layer's closed-form displacement
    gt_u = np.empty((n_frames - 1, H, W), np.float32)
    gt_v = np.empty((n_frames - 1, H, W), np.float32)
    for i in range(n_frames - 1):
        t0, t1 = i * FRAME_DT, (i + 1) * FRAME_DT
        bu, bv = bg_path.flow(t0, t1, grid_z)
        fu, fv = fg_path.flow(t0, t1, grid_z)
        gt_u[i] = np.where(fg_vis[i], fu, bu)
        gt_v[i] = np.where(fg_vis[i], fv, bv)

    gt = {'timestamps': frame_ts, 'x_flow_dist': gt_u, 'y_flow_dist': gt_v}
    return events, frames, frame_ts, gt


def simulate_sequence(rng, duration, seed_phase, speed=1.0,
                      motion='translate'):
    if motion == 'translate':
        return simulate_translate(rng, duration, seed_phase, speed)
    assert motion == 'varied', motion
    return simulate_varied(rng, duration, seed_phase, speed)


def write_sequence(root, ds_name, seq_name, events, frames, frame_ts, gt):
    family = seq_name[:-1]
    seq_dir = root / 'raw' / ds_name / family
    gt_dir = root / 'raw' / ds_name / 'FlowGT' / family
    seq_dir.mkdir(parents=True, exist_ok=True)
    gt_dir.mkdir(parents=True, exist_ok=True)

    inds = np.searchsorted(events[:, 2], frame_ts, side='right') - 1
    with store.open_file(seq_dir / f'{seq_name}_data.hdf5', 'w') as f:
        left = f.create_group('davis').create_group('left')
        left.create_dataset('events', data=events, compression='gzip')
        left.create_dataset('image_raw', data=frames, compression='gzip')
        left.create_dataset('image_raw_ts', data=frame_ts)
        left.create_dataset('image_raw_event_inds',
                            data=inds.astype(np.int64))
    np.savez(gt_dir / f'{seq_name}_gt_flow_dist.npz', **gt)


def write_info(root, ds_name, names, starts):
    """``info/<ds_name>.hdf5``: each sequence's name and start time (the
    info writer of ``main``)."""
    info_dir = root / 'info'
    info_dir.mkdir(parents=True, exist_ok=True)
    with store.open_file(info_dir / f'{ds_name}.hdf5', 'w') as f:
        f.create_dataset('set_name',
                         data=np.array([n.encode() for n in names]))
        f.create_dataset('start_time', data=np.array(starts))


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
