"""The port's visualize CLI and flow rendering against the root CLI and the
JAX package.

- Rendering, bit for bit: ``utils/visualization.flow2img`` against the
  JAX package's on seeded fields, a zero field and a constant one;
  each plugin's ``vis_flow`` (through ``models/loader.load_vis_flow``)
  against the root plugin's ``test.vis_flow``; ``join_images``,
  ``visualize_prediction``, ``visualize_predictions``, the panel below
  the 80-row caption banner, the caption string and the statistics of
  ``prepare_text``, the port's functions against the root CLI's on
  identical inputs (the exactness of tests/utils/test_visualization.py's
  shape and dtype checks, made value for value).
- The PNG writer and reader round-trip, and Pillow decodes the writer's
  file to the same pixels; the caption font has a distinct glyph for
  every printable ASCII character.
- End to end: the root ``visualize.main()`` (in a fresh process, as a
  user runs it, with one writer) and the port's ``main()`` with ``-d
  cpu`` (one writer) over three elements of ``tests/data/seq`` at 64x64,
  from one JAX checkpoint through ``-sp``, for EVFlowNet, DummyFlowNet
  and RecurrentFlowNet on 2-element samples at prefix 1: the same file
  stems, the loss and its photometric terms at tests/test_torch_loss.py's
  loss rtol 1e-5, the flows at tests/test_torch_model.py's rtol 1e-4 /
  atol 1e-6 and the smoothness and border terms, which are sums over the
  flows, at the flows' rtol, the
  input frames' rows of every panel equal, and the flow rows equal but
  for a few pixels (bound below); a second ``main()`` skips every
  panel; ``-d cuda`` without a card raises and stops the writers.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import visualize as root_vis
from dvs_of_training_framework_tpu.training.serializer import \
    Serializer as JaxSerializer
from dvs_of_training_framework_tpu.utils import visualization as jax_render
from dvs_of_training_framework_tpu_torch import visualize as port_vis
from dvs_of_training_framework_tpu_torch.models import (
    dummy_flownet, evflownet, load_vis_flow, recurrent_flownet)
from dvs_of_training_framework_tpu_torch.utils import visualization
from dvs_of_training_framework_tpu_torch.utils.convert import torch_to_flax

REPO = Path(__file__).resolve().parents[1]
PLUGINS = ('EVFlowNet', 'RecurrentFlowNet', 'DummyFlowNet')
H = W = 64


def fields(rng):
    """Seeded flow fields, a zero field and a constant one ([H, W] x, y)."""
    out = [(rng.normal(size=(24, 30)).astype(np.float32),
            rng.normal(size=(24, 30)).astype(np.float32)),
           (1e-3 * rng.normal(size=(8, 8)).astype(np.float32),
            1e-3 * rng.normal(size=(8, 8)).astype(np.float32)),
           (np.zeros((5, 7), np.float32), np.zeros((5, 7), np.float32)),
           (np.full((4, 6), 0.3, np.float32),
            np.full((4, 6), -0.2, np.float32))]
    x, y = rng.normal(size=(2, 16, 16)).astype(np.float32)
    x[::3] = 0.0          # exact axis directions: hue bin edges
    y[:, ::4] = 0.0
    return out + [(x, y)]


def test_flow2img_equals_the_jax_package():
    for fx, fy in fields(np.random.default_rng(0)):
        got = visualization.flow2img(fx, fy)
        want = jax_render.flow2img(fx, fy)
        assert got.dtype == np.uint8 and got.shape == (*fx.shape, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('plugin', PLUGINS)
def test_vis_flow_equals_the_root_plugin(plugin):
    import importlib
    want_fn = importlib.import_module(f'{plugin}.test').vis_flow
    got_fn = load_vis_flow(REPO / plugin)
    assert got_fn is load_vis_flow(plugin) is evflownet.vis_flow
    for fx, fy in fields(np.random.default_rng(1)):
        flow = np.stack([fx, fy], axis=-1)
        np.testing.assert_array_equal(got_fn(flow), want_fn(flow))


def test_a_torch_plugin_directory_gives_its_test_module(tmp_path):
    plugin = tmp_path / 'MyFlowNet'
    plugin.mkdir()
    (plugin / 'test.py').write_text('def vis_flow(flow):\n'
                                    '    return flow[..., :1] * 0\n')
    assert load_vis_flow(plugin)(np.ones((2, 3, 2))).shape == (2, 3, 1)


def host_batch(rng, seq_length, n_events=500):
    return {'events': {'element_index': rng.integers(0, seq_length,
                                                     n_events)},
            'augmentation_params': {'sequence_length':
                                    np.array([seq_length])},
            'images': rng.uniform(0, 255, (seq_length + 1, 1, 16, 20))}


def prediction(rng, n):
    return {'prediction': [rng.normal(size=(n, 2, 16 >> s, 20 >> s))
                           .astype(np.float32) for s in (3, 2, 1, 0)]}


@pytest.mark.parametrize('prefix,suffix,seq_length',
                         [(0, 0, 1), (1, 0, 2), (1, 1, 3)])
def test_panels_equal_the_root_cli(prefix, suffix, seq_length):
    rng = np.random.default_rng(2 + seq_length)
    args = SimpleNamespace(prefix_length=prefix, suffix_length=suffix)
    batch = host_batch(rng, seq_length)
    pred = prediction(rng, 1)
    loss, parts = 2.5, [tuple(rng.uniform(0, 3, 4)) for _ in range(3)]
    weights = [0.5, 1, 1]

    np.testing.assert_array_equal(port_vis.join_images(batch['images']),
                                  root_vis.join_images(batch['images']))
    flows = [scale[0] for scale in pred['prediction']]
    np.testing.assert_array_equal(
        port_vis.visualize_prediction(flows, evflownet.vis_flow),
        root_vis.visualize_prediction(flows, evflownet.vis_flow))
    np.testing.assert_array_equal(
        port_vis.visualize_predictions(args, batch, pred,
                                       evflownet.vis_flow),
        root_vis.visualize_predictions(args, batch, pred,
                                       evflownet.vis_flow))
    caption, statistics = port_vis.prepare_text(args, batch, loss, parts,
                                                weights)
    assert (caption, statistics) == root_vis.prepare_text(
        args, batch, loss, parts, weights)
    assert statistics['prefix_size'] + statistics['pred_size'] \
        + statistics['suffix_size'] == 500

    panel, stats = port_vis.visualize(args, batch, loss, parts, weights,
                                      pred, evflownet.vis_flow)
    want, want_stats = root_vis.visualize(args, batch, loss, parts, weights,
                                          pred, evflownet.vis_flow)
    assert stats == want_stats
    assert panel.shape == want.shape and panel.dtype == np.uint8
    np.testing.assert_array_equal(panel[port_vis.BANNER_ROWS:],
                                  want[port_vis.BANNER_ROWS:])
    # the banner is the caption in the port's font, nothing else
    banner = visualization.draw_text(
        np.zeros((port_vis.BANNER_ROWS, panel.shape[1], 3), np.uint8),
        caption)
    np.testing.assert_array_equal(panel[:port_vis.BANNER_ROWS], banner)
    assert banner.any()


def test_png_round_trip_and_pillow_decode(tmp_path):
    rng = np.random.default_rng(3)
    for shape in ((1, 1, 3), (37, 53, 3), (240, 128, 3)):
        image = rng.integers(0, 256, shape).astype(np.uint8)
        path = tmp_path / f'{shape[0]}.png'
        visualization.write_png(path, image)
        np.testing.assert_array_equal(visualization.read_png(path), image)
        with Image.open(path) as decoded:
            assert decoded.mode == 'RGB'
            np.testing.assert_array_equal(np.asarray(decoded), image)
    assert not list(tmp_path.glob('*.partial'))
    data = bytearray(visualization.encode_png(image))
    data[40] ^= 1                                   # inside IDAT
    with pytest.raises(ValueError, match='CRC'):
        visualization.decode_png(bytes(data))
    with pytest.raises(ValueError):
        visualization.encode_png(image[..., :2])


def test_font_has_a_distinct_glyph_for_every_printable_character():
    glyphs = visualization.GLYPHS
    assert glyphs.shape == (95, visualization.GLYPH_H,
                            visualization.GLYPH_W)
    assert not glyphs[0].any() and all(g.any() for g in glyphs[1:])
    assert len({g.tobytes() for g in glyphs}) == 95
    image = np.zeros((30, 40, 3), np.uint8)
    visualization.draw_text(image, 'A\n\tB' + 'x' * 20)
    a = glyphs[ord('A') - 32]
    np.testing.assert_array_equal(image[:7, :5, 1] == 255, a)
    question = glyphs[ord('?') - 32]        # the tab
    row = visualization.LINE_HEIGHT
    np.testing.assert_array_equal(image[row:row + 7, :5, 0] == 255,
                                  question)


# --- end to end -------------------------------------------------------------

ROOT_RUNNER = r'''
import sys
from pathlib import Path
import numpy as np
out, dump = Path(sys.argv[1]), sys.argv[2]
sys.argv = ['visualize.py'] + sys.argv[3:]
import visualize
visualize.cpu_count = lambda: 1
visualize.choose_output_path = lambda args: (
    out.mkdir(parents=True, exist_ok=True), out)[1]
flows = []
render = visualize.visualize


def capture(*args):
    flows.append([np.asarray(f, np.float32) for f in args[5]['prediction']])
    return render(*args)


visualize.visualize = capture
visualize.main()
np.savez(dump, *[f for batch in flows for f in batch])
'''

# the loss and its image term at tests/test_torch_loss.py's loss rtol; the
# smoothness and border terms are Charbonnier sums of the flows themselves
# (of their differences, of the values that leave the frame), so they
# carry the flows' rtol of tests/test_torch_model.py
STATS_RTOL = {'loss': 1e-5, 'photometric': 1e-5, 'smoothness': 1e-4,
              'border': 1e-4}
CASES = {
    'EVFlowNet': [],
    'DummyFlowNet': [],
    'RecurrentFlowNet': ['--min-sequence-length', '2',
                         '--max-sequence-length', '2', '--prefix-length',
                         '1'],
}


def plugin_weights(plugin):
    gen = torch.Generator().manual_seed(7)
    if plugin == 'EVFlowNet':
        model = evflownet.Model(generator=gen)
    elif plugin == 'RecurrentFlowNet':
        model = recurrent_flownet.Model(prefix_length=1, generator=gen)
    else:
        model = dummy_flownet.Model()
        with torch.no_grad():
            model.flow_bias.copy_(torch.tensor([0.3, -0.2]))
    return model.state_dict()


@pytest.fixture(scope='module')
def split(tmp_path_factory):
    """Three elements of tests/data/seq as both loader splits."""
    root = tmp_path_factory.mktemp('vis_data')
    for name in ('outdoor_day1', 'outdoor_day2'):
        (root / name).mkdir()
        for i in range(3):
            (root / name / f'{i:06d}.hdf5').symlink_to(
                REPO / 'tests' / 'data' / 'seq' / f'{i:06d}.hdf5')
    return root


def run_root(argv, out, env):
    dump = out.parent / f'{out.name}_flows.npz'
    proc = subprocess.run(
        [sys.executable, '-c', ROOT_RUNNER, str(out), str(dump)] + argv,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(dump) as arrays:
        flat = [arrays[f'arr_{i}'] for i in range(len(arrays.files))]
    return [flat[i:i + 4] for i in range(0, len(flat), 4)]


def run_port(argv, out, monkeypatch):
    monkeypatch.setattr(port_vis, 'choose_output_path', lambda args: (
        out.mkdir(parents=True, exist_ok=True), out)[1])
    flows = []
    render = port_vis.visualize

    def capture(*args):
        flows.append(args[5]['prediction'])
        return render(*args)

    monkeypatch.setattr(port_vis, 'visualize', capture)
    record = port_vis.main(argv + ['-d', 'cpu'], num_writers=1)
    return record, flows


@pytest.mark.parametrize('plugin', list(CASES))
def test_main_matches_the_root_cli(plugin, split, tmp_path, monkeypatch):
    ser = JaxSerializer(tmp_path / 'jax_run')
    ser.checkpoint_model(torch_to_flax(plugin_weights(plugin)), {},
                         global_step=1, samples_passed=1)
    ser.wait()
    argv = ['-m', str(tmp_path / 'run'), '-sp', str(ser._id2path(1)),
            '--flownet_path', str(REPO / plugin), '--height', str(H),
            '--width', str(W), '--num_workers', '0', '--event-capacity',
            '4096'] + CASES[plugin]
    env = dict(os.environ, PYTHONPATH=str(REPO), DVS_DATA_PATH=str(split))
    monkeypatch.setenv('DVS_DATA_PATH', str(split))
    want_flows = run_root(argv, tmp_path / 'root', env)
    record, flows = run_port(argv, tmp_path / 'port', monkeypatch)

    n = 3 if plugin != 'RecurrentFlowNet' else 2
    names = sorted(p.name for p in (tmp_path / 'root').iterdir())
    assert names == sorted(p.name for p in (tmp_path / 'port').iterdir())
    assert names == sorted(f'{i:04d}.{ext}' for i in range(n)
                           for ext in ('png', 'yml'))
    assert (record['panels'], record['existing'], record['oversized']) == \
        (n, 0, 0)
    assert len(flows) == len(want_flows) == n
    for got, want in zip(flows, want_flows):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)

    flow_rows = []
    for i in range(n):
        stem = f'{i:04d}'
        want_stats = yaml.safe_load(
            (tmp_path / 'root' / f'{stem}.yml').read_text())
        stats = json.loads((tmp_path / 'port' / f'{stem}.yml').read_text())
        assert yaml.safe_load(
            (tmp_path / 'port' / f'{stem}.yml').read_text()) == stats
        assert stats.keys() == want_stats.keys()
        for key, value in want_stats.items():
            if isinstance(value, int):
                assert stats[key] == value, key
            else:
                np.testing.assert_allclose(stats[key], value,
                                           rtol=STATS_RTOL[key],
                                           err_msg=key)
        with Image.open(tmp_path / 'root' / f'{stem}.png') as image:
            want = np.asarray(image)
        got = visualization.read_png(tmp_path / 'port' / f'{stem}.png')
        assert got.shape == want.shape
        top = port_vis.BANNER_ROWS + H          # banner, then the frames
        np.testing.assert_array_equal(got[port_vis.BANNER_ROWS:top],
                                      want[port_vis.BANNER_ROWS:top])
        flow_rows.append((got[top:], want[top:]))
    # The flow rows differ only where the two frameworks' flows put a
    # pixel's hue (direction in 2-degree bins) or value (magnitude,
    # min-max normalised to 255 steps) on the two sides of a uint8 bin
    # edge.  Their flows differ here by at most ~1e-6 of the largest flow,
    # so a pixel moves only if it lies that close to an edge: one pixel of
    # the 36864 in the RecurrentFlowNet panels did, by one level.  Bound:
    # one pixel in 1000, and no channel by more than one hue bin (2
    # degrees of a 60-degree ramp over 255 levels: 9 levels).
    got = np.concatenate([g for g, _ in flow_rows])
    want = np.concatenate([w for _, w in flow_rows])
    moved = (got != want).any(axis=-1)
    assert moved.mean() <= 1e-3, moved.mean()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 9

    # a second pass finds every panel done and renders none
    before = {p.name: p.read_bytes() for p in (tmp_path / 'port').iterdir()}
    record, flows = run_port(argv, tmp_path / 'port', monkeypatch)
    assert (record['panels'], record['existing'], flows) == (0, n, [])
    assert before == {p.name: p.read_bytes()
                      for p in (tmp_path / 'port').iterdir()}


def test_cuda_without_a_card_raises_and_stops_the_writers(split, tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv('DVS_DATA_PATH', str(split))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    started = []
    pool = port_vis.PanelWriterPool

    def recording_pool(num_writers):
        started.append(pool(num_writers))
        return started[-1]

    monkeypatch.setattr(port_vis, 'PanelWriterPool', recording_pool)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        port_vis.main(['-m', str(tmp_path / 'run'), '-d', 'cuda'],
                      num_writers=2)
    assert not any(w.is_alive() for w in started[0]._writers)
    assert [w.exitcode for w in started[0]._writers] == [0, 0]
