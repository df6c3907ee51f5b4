"""The port's accuracy scripts run the protocol end to end without JAX.

``dvs_of_training_framework_tpu_torch/scripts/{prep,run,eval}_accuracy_varied.sh``
run on the CPU in subprocesses, at a cut size: the three splits of the
``varied`` set at 0.4, 0.25 and 0.25 s (the simulator's textures drawn
with fewer blobs, as ``tests/test_torch_no_jax.py`` draws them), 8
samples at 32x32, EVFlowNet trained 2 steps and then resumed to 3 with
``-d cpu`` and a narrow batch passed as extra arguments, both matrices
scored at frame step 1 and a 32x32 crop (a cut matrix passed as an
extra ``--test-config``, after the script's own).  Every ``python -m``
child of the scripts starts with a directory of stub packages first on
``PYTHONPATH`` (jax, flax, optax, h5py, yaml, psutil, tqdm, msgpack,
PIL: each import raises ``ImportError``, as on a machine without them)
and ``tests/child_probe.py`` as its ``sitecustomize``, which writes,
when the child exits, what it ran and every module it loaded of the JAX
side or from the checkout outside the port's package (the root plugins
and CLIs, ``scripts/``): none may be.  The scripts find the package from the checkout's root,
where they ``cd``; nothing else of the repo is on the path.
"""
import json
import os
import pickle
import re
import sys
from pathlib import Path

from dvs_of_training_framework_tpu_torch.training.serializer import \
    Serializer
from tests.torch_procs import REPO, env, run_group

SCRIPTS = REPO / 'dvs_of_training_framework_tpu_torch' / 'scripts'
CONFIG = REPO / 'dvs_of_training_framework_tpu_torch' / 'config'
BLOCKED = ('jax', 'flax', 'optax', 'h5py', 'yaml', 'psutil', 'tqdm',
           'msgpack', 'PIL')
LIMIT = 240          # seconds a script; the chain takes ~45 s alone

# appended to tests/child_probe.py in the children's sitecustomize.py
FEWER_BLOBS = r'''
import importlib.abc, importlib.machinery


class _FewerBlobs(importlib.abc.MetaPathFinder):
    """Draws the simulator's textures with fewer blobs, by its own code."""
    NAME = 'dvs_of_training_framework_tpu_torch.data.synthetic'

    def find_spec(self, name, path, target=None):
        if name != self.NAME:
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            scene, foreground = module.make_scene, module.make_foreground
            module.make_scene = lambda rng, shape=module.SCENE, \
                num_blobs=260: scene(rng, shape, max(num_blobs // 40, 1))
            module.make_foreground = lambda rng, shape=module.SCENE, \
                num_objects=28: foreground(rng, shape, 4)
        spec.loader.exec_module = exec_module
        return spec


sys.meta_path.insert(0, _FewerBlobs())
'''


def probe_env(tmp_path):
    """The children's environment: the stubs and the probe first on
    ``PYTHONPATH``, a ``python`` that runs this interpreter first on
    ``PATH``; returns it with the directory of the probes' records."""
    site = tmp_path / 'site'
    for name in BLOCKED:
        (site / name).mkdir(parents=True)
        (site / name / '__init__.py').write_text(
            f'raise ImportError("{name} is blocked")\n')
    (site / 'sitecustomize.py').write_text(
        (REPO / 'tests' / 'child_probe.py').read_text() + FEWER_BLOBS)
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    (bin_dir / 'python').write_text(
        f'#!/bin/sh\nexec {sys.executable} "$@"\n')
    (bin_dir / 'python').chmod(0o755)
    probes = tmp_path / 'probes'
    probes.mkdir()
    out = env(PYTHONPATH=str(site), PROBE_DIR=str(probes),
              PROBE_REPO=str(REPO),
              PATH=f'{bin_dir}{os.pathsep}{os.environ["PATH"]}')
    for name in ('DVS_DATA_PATH', 'DVS_DATA_ROOT'):
        out.pop(name, None)
    return out, probes


def script(name, args, environ, **extra):
    """Run one of the port's scripts from a directory outside the
    checkout, its children killed with it if it fails or outlives
    ``LIMIT``; returns its output."""
    logs = Path(environ['PROBE_DIR']).parent / 'logs'
    log_dir = logs / f'{len(list(logs.glob("*")))}-{name}'
    return run_group([['bash', SCRIPTS / name, *args]], log_dir, LIMIT,
                     environ=dict(environ, **extra), cwd=log_dir)[0]


def mtimes(root):
    return {p: p.stat().st_mtime_ns for p in Path(root).rglob('*')
            if p.is_file() and p.name != 'parameters'}


def test_prep_train_resume_eval_without_jax(tmp_path):
    environ, probes = probe_env(tmp_path)
    layout, shards, run = tmp_path / 'layout', tmp_path / 'shards', \
        tmp_path / 'run'
    cut = dict(TRAIN_SECS='0.4', EVAL_SECS='0.25', VAL_SECS='0.25', SIZE='8',
               SHARDS=str(shards),
               PREP_ARGS='--height 32 --width 32 -mbs 2 --num_workers 0')

    # prep builds the layout and the shards, then a second run skips the
    # simulator and the slicing and finds every sample written
    out = script('prep_accuracy_varied.sh', [layout], environ, **cut)
    assert f'wrote {layout}' in out, out
    split = layout / 'training' / 'synth'
    assert (layout / 'info' / 'synth.hdf5').is_dir()
    assert (split / 'outdoor_day2').resolve() == split / 'outdoor_synth2'
    assert (split / 'outdoor_day1').resolve() == split / 'outdoor_synth3'
    built = {**mtimes(layout), **mtimes(shards)}
    assert list(shards.glob('*.hdf5')), sorted(built)
    out = script('prep_accuracy_varied.sh', [layout], environ, **cut)
    assert 'wrote' not in out and '=== prep complete' in out, out
    assert {**mtimes(layout), **mtimes(shards)} == built
    preps = sorted(json.loads(p.read_text())['argv'][0]
                   for p in probes.iterdir())
    assert [Path(a).stem for a in preps] == [
        'make_synthetic_mvsec', 'prepare_batches', 'prepare_batches',
        'sequence2samples'], preps

    # train 2 steps, then the same directory to 3: the second run resumes
    narrow = ['-d', 'cpu', '-bs', '2', '-mbs', '2', '--height', '32',
              '--width', '32', '--num_workers', '0', '--event-capacity',
              '65536', '--device-queue-window', '1']
    layout_env = dict(LAYOUT=str(layout), SHARDS=str(shards))
    script('run_accuracy_varied.sh', [run, *narrow], environ, STEPS='2',
           **layout_env)
    assert Serializer(run).list_known_steps() == [0, 2]
    first = mtimes(run)
    out = script('run_accuracy_varied.sh', [run, *narrow, '-vp', '2'],
                 environ, STEPS='3', SKIP_VALIDATION='0', **layout_env)
    assert '=== training complete ===' in out, out
    serializer = Serializer(run)
    assert serializer.list_known_steps() == [0, 2, 3]
    assert int(serializer.read_state_dict(3)['samples_passed']) == 3 * 2
    for name in ('step_0.ckpt', 'step_2.ckpt'):      # not written again
        assert mtimes(run)[run / name] == first[run / name]
    rss = (run / 'rss.log').read_text().split('\n')
    assert re.fullmatch(r'\d+ \d+', rss[0]), rss

    # eval: both matrices at every kept checkpoint, then their tables;
    # the matrix cut to frame step 1 and a 32x32 crop, given last
    config = json.loads((CONFIG / 'synth_testing.json').read_text())
    for sequence in next(iter(config.values())).values():
        sequence.update(step=[1], test_shape=[32, 32])
    cut_config = tmp_path / 'cut.json'
    cut_config.write_text(json.dumps(config))
    before = set(probes.iterdir())
    out = script('eval_accuracy_varied.sh', [run, tmp_path / 'acc', '-d',
                                             'cpu', '--test-config',
                                             cut_config], environ,
                 **layout_env)
    evals = [json.loads(p.read_text())['argv'] for p in
             sorted(set(probes.iterdir()) - before, key=os.path.getmtime)]
    configs = [[a for i, a in enumerate(argv) if argv[i - 1] ==
                '--test-config'] for argv in evals if argv[0].endswith(
                    f'{os.sep}test.py')]
    port_config = 'dvs_of_training_framework_tpu_torch/config/'
    assert configs == [[port_config + 'synth_val.json', str(cut_config)],
                       [port_config + 'synth_testing.json',
                        str(cut_config)]], evals
    for matrix in ('val', 'eval'):
        pickles = sorted(p.name for p in (tmp_path / f'acc_{matrix}')
                         .glob('*.pkl'))
        assert pickles == ['step_0.pkl', 'step_2.pkl', 'step_3.pkl']
        results = pickle.loads(
            (tmp_path / f'acc_{matrix}' / 'step_3.pkl').read_bytes())
        assert [r.step for r in results] == [1]
        table = out.split(f'### {tmp_path}/acc_{matrix}\n')[1]
        assert [row.split(' | ')[0] for row in table.split('\n')[:3]] == [
            '| step 0', '| step 2', '| step 3'], out
    assert out.index('=== val matrix') < out.index('=== test matrix')

    # no child loaded the JAX package, the root CLIs, plugins or scripts
    records = [json.loads(p.read_text()) for p in probes.iterdir()]
    modules = sorted(Path(r['argv'][0]).stem for r in records)
    assert modules == sorted(
        ['make_synthetic_mvsec', 'sequence2samples'] + ['prepare_batches']
        * 2 + ['train'] * 2 + ['test', 'aee_table'] * 2), modules
    assert [r['foreign'] for r in records] == [[]] * len(records), records
