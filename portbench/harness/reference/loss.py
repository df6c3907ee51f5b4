"""Plain multi-scale self-supervised flow loss, in float32.

Each scale's flow ``[B, 2, h, w]`` is judged against the frames at the
start and the end of its prediction window, resized to ``h x w``
(bilinear, aligned corners, each scale from the previous scale's
frames):

- photometric: the end frame warped by the flow (``F.grid_sample``,
  bilinear, zeros outside, aligned corners) against the start frame,
  the Charbonnier mean;
- smoothness: the Charbonnier means of the flow's differences in four
  directions, averaged;
- out of border: the Charbonnier of the flow values whose warp target
  leaves the frame, each divided by twice its sample's count of such
  pixels times the batch size, summed.

The total is ``0.5 * smoothness + photometric + out of border`` (the
loss weights), each term the mean over scales.  The frames are
constants.
"""
import torch
import torch.nn.functional as F

ALPHA, EPSILON = 0.45, 1e-3


def charbonnier(d):
    return (d * d + EPSILON * EPSILON) ** ALPHA


def match_images(flow_ts, flow_sample_idx, timestamps, sample_idx):
    """Each prediction's start and end frame: the first slot with its
    timestamp and its sample."""
    same = (sample_idx[None, :, None] == flow_sample_idx[None, None, :]) \
        & (timestamps[None, :, None] == flow_ts.T[:, None, :])
    return same.int().argmax(dim=1)               # [2, P]


def scale_terms(prev, nxt, flow):
    N, _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=flow.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=flow.device), indexing='ij')
    gx = (xs + flow[:, 0]) / ((w - 1) / 2.0) - 1.0
    gy = (ys + flow[:, 1]) / ((h - 1) / 2.0) - 1.0
    grid = torch.stack([gx, gy], dim=-1)                       # [N, h, w, 2]
    warped = F.grid_sample(nxt, grid, mode='bilinear', padding_mode='zeros',
                           align_corners=True)
    photometric = charbonnier(warped - prev).mean()
    smoothness = (charbonnier(flow[..., :, 1:] - flow[..., :, :-1]).mean()
                  + charbonnier(flow[..., 1:, :] - flow[..., :-1, :]).mean()
                  + charbonnier(flow[..., 1:, 1:] - flow[..., :-1, :-1])
                  .mean()
                  + charbonnier(flow[..., :-1, 1:] - flow[..., 1:, :-1])
                  .mean()) / 4
    outside = ((grid < -1) | (grid > 1)).any(dim=-1)           # [N, h, w]
    den = outside.reshape(N, -1).sum(dim=1) * 2 * N            # [N]
    value = charbonnier(flow) / torch.where(den > 0, den, 1)[:, None, None,
                                                             None]
    keep = outside[:, None] & (den > 0)[:, None, None, None]
    out_border = torch.where(keep, value, 0.0).sum()
    return smoothness, photometric, out_border


def multiscale_loss(flows, flow_ts, flow_sample_idx, batch,
                    weights=(0.5, 1.0, 1.0)):
    """``(loss, (smoothness[S], photometric[S], out_border[S]))``."""
    start, stop = match_images(flow_ts, flow_sample_idx,
                               batch['timestamps'], batch['sample_idx'])
    images = batch['images']
    terms = []
    for flow in flows:
        if tuple(images.shape[-2:]) != tuple(flow.shape[-2:]):
            images = F.interpolate(images, size=flow.shape[-2:],
                                   mode='bilinear', align_corners=True)
        terms.append(scale_terms(images[start], images[stop], flow.float()))
    terms = tuple(zip(*terms))
    loss = sum(w * (sum(t) / len(t)) for t, w in zip(terms, weights))
    return loss, terms
