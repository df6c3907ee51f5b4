"""MVSEC optical-flow benchmark math: AEE / %AEE and GT flow propagation.

Reference: utils/eval.py.  The ground-truth flow maps are asynchronous with
the grayscale frames, so GT displacement between two frame timestamps is
obtained by iteratively propagating pixel positions through the intermediate
GT flows (nearest-neighbour remapping, implemented in NumPy — no OpenCV
dependency).

The port's copy of ``dvs_of_training_framework_tpu/evaluation/
flow_metrics.py``, unchanged.
"""
import numpy as np


def masked_gt(flow_gt, event_img, is_car=False, is_dense=False):
    """The benchmark's pixel mask applied to the GT: ``[N, 2]`` flows.

    This is the EXACT masking used by :func:`flow_error_dense` (event-active
    AND finite, non-zero GT, after the max-row crop), factored out so
    baselines that need the masked GT itself — e.g. the constant-flow
    oracle — cannot diverge from the metric.

    Returns (gt_masked ``[N, 2]``, crop+mask applier for predictions).
    """
    # Bug-for-bug parity with the public EV-FlowNet benchmark code the
    # reference vendored (utils/eval.py:16): the row bound is taken from
    # shape[1] (the WIDTH, 346) rather than the height (260), so without
    # is_car no row is actually cropped.  Kept intentionally — changing it
    # would make AEE numbers incomparable with the reference harness.
    max_row = flow_gt.shape[1]
    if is_car:
        max_row = 190

    event_img_cropped = np.squeeze(event_img)[:max_row, :]
    flow_gt_cropped = flow_gt[:max_row, :, :]

    if is_dense:
        event_mask = np.ones(event_img_cropped.shape, dtype=bool)
    else:
        event_mask = event_img_cropped > 0

    # valid GT: finite and non-zero
    flow_mask = np.logical_and(
        np.logical_and(~np.isinf(flow_gt_cropped[:, :, 0]),
                       ~np.isinf(flow_gt_cropped[:, :, 1])),
        np.linalg.norm(flow_gt_cropped, axis=2) > 0)
    total_mask = np.squeeze(np.logical_and(event_mask, flow_mask))

    def apply(flow_pred):
        return flow_pred[:max_row, :, :][total_mask, :]

    return flow_gt_cropped[total_mask, :], apply


def _endpoint_stats(gt_masked, pred_masked):
    EE = np.linalg.norm(gt_masked - pred_masked, axis=-1)
    n_points = EE.shape[0]
    AEE = np.mean(EE) if n_points else 0.0
    thresh = 3.0
    percent_AEE = float((EE < thresh).sum()) / float(EE.shape[0] + 1e-5)
    return AEE, percent_AEE, n_points


def endpoint_error_stats(flow_gt, flow_pred, event_img, is_car=False,
                         is_dense=False):
    """Per-window endpoint-error statistics, mean AND robust.

    Same masking as :func:`flow_error_dense`, plus the median endpoint
    error — the mean is outlier-sensitive (a handful of hard windows can
    spike a checkpoint's mAEE while the typical pixel keeps improving,
    ACCURACY.md round-4 caveat), so per-window dumps carry both.

    Returns dict(aee, percent_aee, median_ee, n_points).
    """
    gt_masked, apply_mask = masked_gt(flow_gt, event_img, is_car, is_dense)
    pred_masked = apply_mask(flow_pred)
    EE = np.linalg.norm(gt_masked - pred_masked, axis=-1)
    n_points = EE.shape[0]
    return dict(
        aee=float(np.mean(EE)) if n_points else 0.0,
        percent_aee=float((EE < 3.0).sum()) / float(n_points + 1e-5),
        median_ee=float(np.median(EE)) if n_points else 0.0,
        n_points=int(n_points))


def flow_error_dense(flow_gt, flow_pred, event_img, is_car=False,
                     is_dense=False):
    """Average endpoint error over event-active, valid-GT pixels.

    Args:
        flow_gt: ``[H, W, 2]`` ground-truth displacement.
        flow_pred: ``[H, W, 2]`` prediction.
        event_img: per-pixel event counts; pixels without events are
            excluded unless ``is_dense``.
        is_car: evaluate only the top 190 rows (crops the car hood absent
            from GT).

    Returns:
        (AEE, fraction of masked pixels with EE < 3 px, n_points)
    """
    gt_masked, apply_mask = masked_gt(flow_gt, event_img, is_car, is_dense)
    return _endpoint_stats(gt_masked, apply_mask(flow_pred))


def geometric_median(points, iters=64, eps=1e-7):
    """Weiszfeld geometric median of ``[N, 2]`` points (AEE minimiser).

    The mean minimises the SQUARED endpoint error; the metric is the mean
    NORM, whose constant minimiser is the geometric median.  Initialised at
    the mean; a handful of Weiszfeld iterations converge to well under the
    benchmark's resolution.
    """
    if points.shape[0] == 0:
        return np.zeros(points.shape[1:], points.dtype)
    z = points.mean(axis=0)
    for _ in range(iters):
        d = np.linalg.norm(points - z, axis=-1)
        w = 1.0 / np.maximum(d, eps)
        z_new = (points * w[:, None]).sum(axis=0) / w.sum()
        if np.linalg.norm(z_new - z) < 1e-9:
            z = z_new
            break
        z = z_new
    return z


def constant_flow_oracle(flow_gt, event_img, is_car=False):
    """Best achievable AEE for a SINGLE 2-vector prediction on this window.

    The skeptic's baseline for spatially-varying GT (VERDICT round 3): a
    model that regresses one global flow vector per frame pair can do no
    better than this.  Evaluates both the masked mean and the geometric
    median (the true AEE minimiser) and returns whichever scores lower.

    Returns (AEE, %AEE<3px, n_points, oracle_vector).
    """
    gt_masked, _ = masked_gt(flow_gt, event_img, is_car)
    best = None
    for vec in (gt_masked.mean(axis=0) if gt_masked.size else
                np.zeros(2, np.float32),
                geometric_median(gt_masked)):
        aee, paee, n = _endpoint_stats(gt_masked,
                                       np.broadcast_to(vec,
                                                       gt_masked.shape))
        if best is None or aee < best[0]:
            best = (aee, paee, n, np.asarray(vec, np.float32))
    return best


def _remap_nearest(src, mapx, mapy):
    """NumPy equivalent of cv2.remap(..., INTER_NEAREST) with zero border."""
    H, W = src.shape[:2]
    xi = np.rint(mapx).astype(np.int64)
    yi = np.rint(mapy).astype(np.int64)
    inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xi = np.clip(xi, 0, W - 1)
    yi = np.clip(yi, 0, H - 1)
    out = src[yi, xi]
    out[~inside] = 0
    return out.astype(src.dtype)


def prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask,
              scale_factor=1.0):
    """Advance pixel positions by the flow sampled at their locations.

    Positions whose sampled flow is exactly 0 are masked out (matching the
    reference's treatment of the invalid-flow sentinel).
    Mutates ``x_indices/y_indices/x_mask/y_mask`` in place.
    """
    flow_x_interp = _remap_nearest(x_flow, x_indices, y_indices)
    flow_y_interp = _remap_nearest(y_flow, x_indices, y_indices)

    x_mask[flow_x_interp == 0] = False
    y_mask[flow_y_interp == 0] = False

    x_indices += flow_x_interp * scale_factor
    y_indices += flow_y_interp * scale_factor


def estimate_corresponding_gt_flow(x_flow_in, y_flow_in, gt_timestamps,
                                   start_time, end_time):
    """GT displacement between ``start_time`` and ``end_time``.

    Each stored GT flow covers [gt_ts[i], gt_ts[i+1]].  If the requested
    window sits inside one GT interval the flow is linearly scaled;
    otherwise pixel positions are chained through every intermediate GT
    flow and the net displacement returned.
    """
    gt_iter = np.searchsorted(gt_timestamps, start_time, side='right') - 1
    gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = np.squeeze(x_flow_in[gt_iter, ...])
    y_flow = np.squeeze(y_flow_in[gt_iter, ...])

    dt = end_time - start_time
    if gt_dt > dt:
        return x_flow * dt / gt_dt, y_flow * dt / gt_dt

    x_indices, y_indices = np.meshgrid(np.arange(x_flow.shape[1]),
                                       np.arange(x_flow.shape[0]))
    x_indices = x_indices.astype(np.float32)
    y_indices = y_indices.astype(np.float32)

    orig_x_indices = np.copy(x_indices)
    orig_y_indices = np.copy(y_indices)

    x_mask = np.ones(x_indices.shape, dtype=bool)
    y_mask = np.ones(y_indices.shape, dtype=bool)

    scale_factor = (gt_timestamps[gt_iter + 1] - start_time) / gt_dt
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask,
              scale_factor=scale_factor)
    gt_iter += 1

    while gt_timestamps[gt_iter + 1] < end_time:
        x_flow = np.squeeze(x_flow_in[gt_iter, ...])
        y_flow = np.squeeze(y_flow_in[gt_iter, ...])
        prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask)
        gt_iter += 1

    final_dt = end_time - gt_timestamps[gt_iter]
    final_gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = np.squeeze(x_flow_in[gt_iter, ...])
    y_flow = np.squeeze(y_flow_in[gt_iter, ...])
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask,
              final_dt / final_gt_dt)

    x_shift = x_indices - orig_x_indices
    y_shift = y_indices - orig_y_indices
    x_shift[~x_mask] = 0
    y_shift[~y_mask] = 0
    return x_shift, y_shift
