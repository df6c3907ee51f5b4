"""Port parity: EVFlowNet's flow heads (``ops/flow_head_cuda.py``).

The twin (``flow_head_cuda.plain``, ``F.conv2d`` on the features cast to
float32) against flax's head in the JAX package (``EVFlowNet/net.py``
``Predictor``: ``nn.Conv(2, (1, 1), dtype=float32)`` on
``x.astype(float32)``): the flow and the gradients of the features, the
weight and the bias, at the four heads' channel counts with their
bench-shape planes cut by 8 a side, on bf16 and fp32 features.  Tolerances
are those of the flows in tests/test_torch_model.py::
test_predictor_matches_flax (rtol 1e-4, atol 1e-6), the atol times the
tensor's largest magnitude where that passes 1 (the weight's and bias's
gradients are sums over every pixel).  A bf16 feature gradient is the same
float32 value rounded once to bf16 on both sides, and the two frameworks'
float32 data gradients may differ in their last bit, which can move that
rounding by one bf16 step: it takes rtol 2^-7, one bf16 step relative.
Then: the wrapper sends CPU tensors to the twin and launches nothing;
``check_inputs`` refuses what the kernel does not take; a ``Predictor``
with ``plain_ops`` equals one without on the CPU, outputs and gradients.

On a card (the tests marked ``cuda``) the kernel and the fp32 twin are
both held against a float64 evaluation at the four bench shapes (B 8,
256x256, base 64) and at two ragged ones, on bf16 and fp32 features: on
the flow and on each gradient the kernel's largest error, relative to the
tensor's largest magnitude, may be at most twice the twin's, or 4 fp32
ulps where the twin lands within about one (the rule of
tests/test_torch_kernel_mlp.py).  Two backward calls give the same bits,
and a CUDA graph's replay gives the eager call's bits.  The card's machine
has no JAX, so the JAX imports are optional there; run the card's tests
with ``python -m pytest --noconftest -m cuda tests/test_torch_flow_head.py``.
"""
import numpy as np
import pytest
import torch

try:
    import flax.linen as linen
    import jax
    import jax.numpy as jnp
except ModuleNotFoundError:     # a card's machine: the cuda tests only
    jax = None
from dvs_of_training_framework_tpu_torch.models import evflownet
from dvs_of_training_framework_tpu_torch.models import recurrent_flownet
from dvs_of_training_framework_tpu_torch.ops import flow_head_cuda

# (channels, plane side) of the four heads at the bench shape (B 8,
# 256x256, base 64), and at the CPU tests' sizes (B 2, sides cut by 8)
BENCH_HEADS = [(256, 32), (128, 64), (64, 128), (32, 256)]
CPU_HEADS = [(ch, side // 8) for ch, side in BENCH_HEADS]
DTYPES = [torch.bfloat16, torch.float32]
F64_FLOOR = 4 * 2.0 ** -23   # 4 fp32 ulps of a tensor's scale


def make_args(seed, batch, channels, plane, dtype):
    """Features, weight, bias and the flow's cotangent, from numpy."""
    rng = np.random.default_rng(seed)
    H, W = plane
    x = torch.from_numpy(rng.normal(size=(batch, channels, H, W))
                         .astype(np.float32)).to(dtype)
    weight = torch.from_numpy((rng.normal(size=(2, channels, 1, 1))
                               / np.sqrt(channels)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(2,)).astype(np.float32) * 0.1)
    cot = torch.from_numpy(rng.normal(size=(batch, 2, H, W))
                           .astype(np.float32))
    return x, weight, bias, cot


def flax_head(x, kernel, bias):
    """The JAX package's flow head on NHWC features."""
    conv = linen.Conv(2, (1, 1), dtype=jnp.float32)
    return conv.apply({'params': {'kernel': kernel, 'bias': bias}},
                      x.astype(jnp.float32))


def assert_close(got, want, rtol, name):
    got = got.detach().float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                               err_msg=name)


@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
@pytest.mark.parametrize('channels,side', CPU_HEADS)
def test_twin_matches_flax_head(channels, side, dtype):
    x, weight, bias, cot = make_args(0, 2, channels, (side, side), dtype)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jdtype)
    kernel = jnp.asarray(weight.permute(2, 3, 1, 0).numpy())   # HWIO
    want, vjp = jax.vjp(flax_head, jx, kernel, jnp.asarray(bias.numpy()))
    want_dx, want_dw, want_db = vjp(jnp.asarray(
        cot.permute(0, 2, 3, 1).numpy()))

    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    flow = flow_head_cuda.plain(*leaves)
    assert flow.dtype == torch.float32
    assert flow.shape == (2, 2, side, side)
    dx, dw, db = torch.autograd.grad(flow, leaves, cot)
    assert dx.dtype == dtype
    assert_close(flow, np.asarray(want).transpose(0, 3, 1, 2), 1e-4, 'flow')
    assert_close(dx, np.asarray(want_dx.astype(jnp.float32))
                 .transpose(0, 3, 1, 2),
                 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4, 'dx')
    assert_close(dw, np.asarray(want_dw).transpose(3, 2, 0, 1), 1e-4, 'dw')
    assert_close(db, np.asarray(want_db), 1e-4, 'db')


@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
def test_wrapper_routes_cpu_tensors_to_twin(dtype):
    x, weight, bias, cot = make_args(1, 2, 16, (6, 10), dtype)
    before = dict(flow_head_cuda.launches)
    results = []
    for fn in (flow_head_cuda.flow_head, flow_head_cuda.plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
        flow = fn(*leaves)
        results.append([flow, *torch.autograd.grad(flow, leaves, cot)])
    for got, want in zip(*results):
        assert torch.equal(got, want)
    assert flow_head_cuda.launches == before == {'fwd': 0, 'bwd': 0}


def _refused():
    x, weight, bias, _ = make_args(2, 2, 8, (4, 4), torch.bfloat16)
    wide = torch.zeros(1, flow_head_cuda.MAX_CHANNELS + 1, 2, 2)
    return {
        'x channels_last': (x.to(memory_format=torch.channels_last),
                            weight, bias),
        'x 3-D': (x[0], weight, bias),
        'x empty': (x[:0], weight, bias),
        'x float16': (x.half(), weight, bias),
        'x float64': (x.double(), weight, bias),
        'weight channels': (x, torch.zeros(2, 9, 1, 1), bias),
        'weight 3x3': (x, torch.zeros(2, 8, 3, 3), bias),
        'weight bfloat16': (x, weight.bfloat16(), bias),
        'weight strided': (x, torch.zeros(8, 2, 1, 1).permute(1, 0, 2, 3),
                           bias),
        'bias 3': (x, weight, torch.zeros(3)),
        'bias float64': (x, weight, bias.double()),
        'too many channels': (wide, torch.zeros(2, wide.shape[1], 1, 1),
                              bias),
    }


@pytest.mark.parametrize('case', list(_refused()))
def test_check_inputs_refuses(case):
    with pytest.raises(ValueError):
        flow_head_cuda.check_inputs(*_refused()[case])


@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
def test_check_inputs_takes_the_heads_inputs(dtype):
    for channels, side in CPU_HEADS:
        x, weight, bias, _ = make_args(3, 2, channels, (side, side), dtype)
        flow_head_cuda.check_inputs(x, weight, bias)


@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
def test_predictor_plain_ops_equal_on_cpu(dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 4, 32, 32))
                         .astype(np.float32)).to(dtype)
    results = []
    for plain_ops in (True, False):
        predictor = evflownet.Predictor(
            4, 8, torch.Generator().manual_seed(0), dtype=dtype,
            plain_ops=plain_ops)
        assert predictor.plain_ops is plain_ops
        flows, features = predictor(x)
        value = sum((f * (i + 1)).sum() for i, f in enumerate(flows))
        params = list(predictor.parameters())
        grads = torch.autograd.grad(value, params)
        results.append([*flows, *features, *grads])
    for got, want in zip(*results):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_models_pass_plain_ops_to_the_predictor():
    for plain_ops in (True, False):
        for model in (evflownet.Model(base_channels=8, plain_ops=plain_ops),
                      recurrent_flownet.Model(base_channels=8,
                                              hidden_channels=8,
                                              plain_ops=plain_ops)):
            assert model.predictor.plain_ops is plain_ops
            assert model.quantization_layer.plain_ops is plain_ops


# --- on a card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = tf32


def in_float64(x, weight, bias, cot):
    """The head's flow and its three gradients in float64."""
    w = weight.reshape(2, -1)
    flow = torch.einsum('kc,bchw->bkhw', w, x) + bias[None, :, None, None]
    dx = torch.einsum('kc,bkhw->bchw', w, cot)
    dw = torch.einsum('bkhw,bchw->kc', cot, x).reshape(weight.shape)
    return flow, dx, dw, cot.sum((0, 2, 3))


def run_head(fn, args, device):
    x, weight, bias, cot = (t.to(device) for t in args)
    leaves = [t.requires_grad_(True) for t in (x, weight, bias)]
    flow = fn(*leaves)
    return [flow, *torch.autograd.grad(flow, leaves, cot)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
@pytest.mark.parametrize('batch,channels,plane', [
    (8, ch, (side, side)) for ch, side in BENCH_HEADS]
    + [(3, 48, (33, 35)), (2, 3, (5, 7))])
def test_kernel_keeps_fp32_accuracy(card, batch, channels, plane, dtype):
    args = make_args(5, batch, channels, plane, dtype)
    before = flow_head_cuda.launches['bwd']
    kernel = run_head(flow_head_cuda.flow_head, args, card)
    assert flow_head_cuda.launches['bwd'] == before + 1
    twin = run_head(flow_head_cuda.plain, args, card)
    exact = in_float64(*(t.double().to(card) for t in args))
    for name, k, t, e in zip(['flow', 'dx', 'dw', 'db'], kernel, twin,
                             exact):
        assert k.dtype == t.dtype and k.shape == t.shape, name
        scale = e.abs().max().item()
        err_k, err_t = ((g.double() - e).abs().max().item() / scale
                        for g in (k, t))
        assert err_k <= max(2 * err_t, F64_FLOOR), (name, err_k, err_t)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
def test_kernel_is_deterministic(card, dtype):
    for channels, side in BENCH_HEADS:
        args = make_args(6, 8, channels, (side, side), dtype)
        first, second = (run_head(flow_head_cuda.flow_head, args, card)
                         for _ in range(2))
        for name, a, b in zip(['flow', 'dx', 'dw', 'db'], first, second):
            assert torch.equal(a, b), (channels, name)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=['bf16', 'fp32'])
def test_graph_replay_equals_eager(card, dtype):
    for channels, side in BENCH_HEADS:
        x, weight, bias, cot = (t.to(card) for t in make_args(
            7, 8, channels, (side, side), dtype))
        leaves = [t.requires_grad_(True) for t in (x, weight, bias)]

        def step():
            # nothing keeps a step's autograd graph alive after it, so no
            # node of one step's graph ties the next step to its stream
            flow = flow_head_cuda.flow_head(*leaves)
            return [flow.detach(), *torch.autograd.grad(flow, leaves, cot)]

        # as training/state.py's WindowGraph: a warm-up on a side stream,
        # the capture, then the replay; the eager call after them
        side_stream = torch.cuda.Stream()
        side_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side_stream):
            step()
        torch.cuda.current_stream().wait_stream(side_stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = step()
        graph.replay()
        eager = step()
        torch.cuda.synchronize()
        for name, a, b in zip(['flow', 'dx', 'dw', 'db'], eager, captured):
            assert torch.equal(a, b), (channels, name)
