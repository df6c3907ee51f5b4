"""Published peaks of one H100 and the least time a kernel's work needs.

A frozen copy of ``chip_smoke.py``'s ``bound`` and ``kernel_mlp_work``
and of its byte counts of K1 (``voxelize_times``) and K3 (phase 4), with
the bytes of a weight in the weights' dtype.  Peaks: NVIDIA's H100 SXM
data sheet, dense: 989 TFLOP/s bf16 on the tensor cores, 495 TF32, 67
fp32 on the CUDA cores, 3.35 TB/s of HBM3; special-function (MUFU)
results 16 a clock an SM against the fp32 peak's 128 FMAs (256 flop).
"""
BF16_FLOPS, TF32_FLOPS, FP32_FLOPS = 989e12, 495e12, 67e12
MEMORY_BYTES_S = 3.35e12
SFU_OPS = FP32_FLOPS / 16
# the peak that a configuration's compute type runs at (TF32 is off)
PEAK_FLOPS = {'bfloat16': BF16_FLOPS, 'float32': FP32_FLOPS}


def bound(nbytes=0.0, flops=0.0, mma_flops=0.0, sfu_ops=0.0):
    """Seconds the card needs at least to move ``nbytes`` of device
    memory and do ``flops`` fp32 operations on the CUDA cores,
    ``mma_flops`` fp32 products on the tensor cores as 3xTF32 (three TF32
    products each) and ``sfu_ops`` special-function operations: the
    units run side by side, so the slowest sets it."""
    return max(nbytes / MEMORY_BYTES_S, flops / FP32_FLOPS,
               3 * mma_flops / TF32_FLOPS, sfu_ops / SFU_OPS)


def k1_work(capacity, n_valid, n_cells, planes, height, width, depth,
            weight_bytes):
    """``{'fwd': bound kwargs, 'bwd': ...}`` of K1 (voxelize) on one
    batch: the forward reads x, y, plane and valid of every row (13
    bytes) and the weights of the valid rows, and writes every cell of
    the float32 grid; the backward reads the same indices and the grid's
    gradient at the cells the valid rows touch, and writes every row's
    weight gradient.  Its additions are far below the bytes' time."""
    index = 13 * capacity
    return {'fwd': dict(nbytes=index + weight_bytes * n_valid * depth
                        + 4 * planes * height * width * depth,
                        flops=n_valid * depth),
            'bwd': dict(nbytes=index + 4 * n_cells * depth
                        + weight_bytes * capacity * depth)}


def k2_work(points, hd):
    """K2 (the kernel MLP ``1 -> hd -> hd -> 1``, tanh) at ``points``
    points.  Products: h1 W2 (2 hd^2 a point); the backward recomputes
    it and adds dh1 = dz2 W2^T and dW2 += h1^T dz2.  Vector work: w1 d +
    b1 (2 hd), + b2 (hd), w3 . h2 + b3 (2 hd + 1); backward also dz2 (3
    hd), dw3 (2 hd), db2 (hd), dz1 (2 hd), d(delta) (2 hd), dw1 (2 hd),
    db1 (hd) and db3 (1).  Each tanh is one special-function operation,
    2 hd a point both ways.  Bytes: delta and the output (forward);
    delta, its cotangent and d(delta) (backward)."""
    fwd = dict(flops=points * (5 * hd + 1), mma_flops=points * 2 * hd * hd,
               sfu_ops=points * 2 * hd, nbytes=8 * points)
    bwd = dict(flops=points * (18 * hd + 2), mma_flops=3 * fwd['mma_flops'],
               sfu_ops=fwd['sfu_ops'], nbytes=12 * points)
    return {'fwd': fwd, 'bwd': bwd}


def k3_work(frames, height, width):
    """K3's fused warp at one scale: ``frames`` single-channel float32
    frames of ``height x width``, one point a pixel.  Each input read
    once and each output written once: forward the frames, the grid (2
    floats a point) and the warped frames; backward the frames, the grid,
    the cotangent and the grid's gradient."""
    points = frames * height * width
    frame_bytes = 4 * points
    return {'fwd': dict(nbytes=frame_bytes + 4 * (2 + 1) * points),
            'bwd': dict(nbytes=frame_bytes + 4 * (2 + 1 + 2) * points)}
