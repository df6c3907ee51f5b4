"""Multi-scale self-supervised optical-flow objective.

Counterpart of ``dvs_of_training_framework_tpu/losses/loss.py``:

- photometric: warp the *next* frame with the predicted flow (bilinear,
  align_corners) and penalise the Charbonnier difference to the *previous*
  frame,
- smoothness: Charbonnier of 4-direction flow differences,
- out-of-border: Charbonnier of flow values whose warp target leaves the
  [-1, 1] grid, normalised per sample.

Everything is computed at fixed shapes with masked reductions, so the loss
needs no host synchronisation.

The warp has two forms, as in the JAX package: ``F.grid_sample`` (the
golden path) and ``grid_sample_onehot``, whose corner values come from
the K3 kernel on the card (the bf16x2 recipe).  ``bf16x2`` is the JAX
package's tri-state loss precision (False, True or ``'x1'``, from
``LOSS_PRECISIONS``); on Hopper every mode gives exact fp32 corners, so
it only selects the form.
"""
from typing import Sequence, Tuple

import torch

from ..ops.charbonnier import charbonnier_loss
from ..ops.resize import resize_bilinear
from ..ops.warp import grid_sample, grid_sample_onehot

# --loss-precision -> the bf16x2 flag (JAX losses/loss.py init_losses)
LOSS_PRECISIONS = {'highest': False, 'bf16x2': True, 'bf16x1': 'x1'}


class SingleScaleLoss:
    """Loss terms for one prediction scale ``(H, W)``.

    ``use_mxu_warp``: None picks the corner warp exactly for CUDA frames
    of one channel under a truthy ``bf16x2`` (the JAX package's
    ``_use_pallas`` policy, with the card in the TPU's place), and
    ``F.grid_sample`` otherwise; True or False force one form.
    ``plain_ops=True`` gives the corner warp its plain twin instead of the
    K3 kernel.
    """

    def __init__(self, pred_shape: Tuple[int, int], use_mxu_warp=None,
                 bf16x2=False, plain_ops: bool = False):
        self.H, self.W = int(pred_shape[0]), int(pred_shape[1])
        self._grid = {}   # pixel-coordinate base grid [2, H, W] per device
        self.use_mxu_warp = use_mxu_warp
        self.bf16x2 = bf16x2
        self.plain_ops = plain_ops

    def base_grid(self, device) -> torch.Tensor:
        if device not in self._grid:
            ys, xs = torch.meshgrid(
                torch.arange(self.H, dtype=torch.float32, device=device),
                torch.arange(self.W, dtype=torch.float32, device=device),
                indexing='ij')
            self._grid[device] = torch.stack([xs, ys], dim=0)   # (x, y)
        return self._grid[device]

    def _warp_grid(self, flow):
        """Normalised sampling grid: (base + flow) mapped to [-1, 1]."""
        grid = self.base_grid(flow.device)[None] + flow         # [N, 2, H, W]
        gx = grid[:, 0] / ((self.W - 1) / 2.0) - 1.0
        gy = grid[:, 1] / ((self.H - 1) / 2.0) - 1.0
        return torch.stack([gx, gy], dim=1)                     # [N, 2, H, W]

    def _corner_warp(self, images) -> bool:
        if self.use_mxu_warp is None:
            return bool(self.bf16x2) and images.is_cuda \
                and images.shape[1] == 1
        return bool(self.use_mxu_warp)

    def photometric_loss(self, prev_images, next_images, warp_grid):
        nhwc_grid = warp_grid.permute(0, 2, 3, 1)
        if self._corner_warp(next_images):
            warped = grid_sample_onehot(next_images, nhwc_grid, self.bf16x2,
                                        self.plain_ops)
        else:
            warped = grid_sample(next_images, nhwc_grid)
        return charbonnier_loss(warped - prev_images)

    def smoothness_loss(self, flow):
        ucrop = flow[..., 1:, :]
        dcrop = flow[..., :-1, :]
        lcrop = flow[..., 1:]
        rcrop = flow[..., :-1]

        ulcrop = flow[..., 1:, 1:]
        drcrop = flow[..., :-1, :-1]
        dlcrop = flow[..., :-1, 1:]
        urcrop = flow[..., 1:, :-1]

        return (charbonnier_loss(lcrop - rcrop)
                + charbonnier_loss(ucrop - dcrop)
                + charbonnier_loss(ulcrop - drcrop)
                + charbonnier_loss(dlcrop - urcrop)) / 4

    def outborder_regularization_loss(self, flow, warp_grid):
        N = flow.shape[0]
        # pixels whose x or y warp target leaves [-1, 1]; a bool mask
        # carries no gradient
        mask = ((warp_grid < -1) | (warp_grid > 1)).sum(dim=1) > 0  # [N,H,W]
        # per-sample count of penalised values (x and y channels both count)
        denominators = mask.reshape(N, -1).sum(dim=1) * 2           # [N]
        den = (denominators * N)[:, None, None, None].to(flow.dtype)
        return charbonnier_loss(flow, mask=mask[:, None].expand_as(flow),
                                denominator=den)

    def __call__(self, prev_images, next_images, flow):
        if prev_images.shape != next_images.shape:
            raise ValueError(f'{prev_images.shape} vs {next_images.shape}')
        if tuple(prev_images.shape[-2:]) != (self.H, self.W):
            raise ValueError(f'{prev_images.shape} vs {(self.H, self.W)}')
        warp_grid = self._warp_grid(flow)
        photometric = self.photometric_loss(prev_images, next_images,
                                            warp_grid)
        smoothness = self.smoothness_loss(flow)
        outborder = self.outborder_regularization_loss(flow, warp_grid)
        return smoothness, photometric, outborder


def match_predictions_to_images(flow_ts, flow_sample_idx,
                                timestamps, sample_idx):
    """Indices of the (start, stop) image for every prediction: the first
    d with ``timestamps[d] == flow_ts[p, f]`` and ``sample_idx[d] ==
    flow_sample_idx[p]``."""
    sample_mask = sample_idx[None, :, None] == \
        flow_sample_idx[None, None, :]                      # [1, D, P]
    ts_mask = timestamps[None, :, None] == \
        flow_ts.T[:, None, :]                               # [2, D, P]
    image_mask = (ts_mask & sample_mask).to(torch.int32)    # [2, D, P]
    return image_mask[0].argmax(dim=0), image_mask[1].argmax(dim=0)


class MultiScaleLoss:
    """Per-scale losses over a tuple of flow predictions.

    The image interpolation is chained across scales as in the reference:
    scale i+1 resizes the scale-i images, not the originals.  ``bf16x2``
    and ``plain_ops`` go to every scale (see ``SingleScaleLoss``).
    """

    def __init__(self, shapes: Sequence[Tuple[int, int]], bf16x2=False,
                 plain_ops: bool = False):
        self.shapes = [tuple(map(int, s)) for s in shapes]
        self.losses = [SingleScaleLoss(s, bf16x2=bf16x2, plain_ops=plain_ops)
                       for s in self.shapes]

    def __call__(self, flows, flow_ts, flow_sample_idx, images, timestamps,
                 sample_idx):
        start_indices, stop_indices = match_predictions_to_images(
            flow_ts, flow_sample_idx, timestamps, sample_idx)
        result = []
        images = images.detach()
        for loss, flow in zip(self.losses, flows):
            images = resize_bilinear(images, flow.shape[-2:])
            result.append(loss(images[start_indices], images[stop_indices],
                               flow))
        return tuple(zip(*result))


def combined_loss(evaluator, flows, flow_ts, flow_sample_idx, images,
                  timestamps, sample_idx, weights=(0.5, 1, 1)):
    """Weighted sum of the mean per-scale loss terms, in the order
    (smoothness, photometric, outborder)."""
    terms = evaluator(flows, flow_ts, flow_sample_idx, images,
                      timestamps, sample_idx)
    loss = sum(w * (sum(t) / len(t)) for t, w in zip(terms, weights))
    return loss, terms
