"""Nothing a cell's run loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
plain reference loads nothing of the port."""
import subprocess
import sys
import textwrap

import helpers

BLOCK = '''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{here!r}, {repo!r}]
'''


def run_python(code, blocked, tmp_path):
    script = tmp_path / 'probe.py'
    script.write_text(f'BLOCKED = {blocked!r}\n' + BLOCK.format(
        here=str(helpers.HERE), repo=str(helpers.HERE.parent))
        + textwrap.dedent(code))
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    root = helpers.tiny_checkout(tmp_path)
    done = run_python(f'''
        import torch
        from harness import calibrate, cli, spec
        cell = spec.Cell(spec.load_benchmark({str(root)!r}),
                         'evflownet.recipe_b8', {str(root / 'portbench')!r})
        cell.readers(), cell.reference()
        code = cli.main(['--workload', 'evflownet.recipe_b8',
                         '--seed', '9', '--seconds', '0.3', '--trace', '0'],
                        device=torch.device('cpu'), root={str(root)!r})
        loaded = sorted({{m.split('.')[0] for m in sys.modules}})
        print('EXIT', code, 'PORT', 'dvs_of_training_framework_tpu_torch'
              in loaded, 'FOUND', cli.forbidden_modules())
    ''', {'jax', 'jaxlib', 'flax', 'dvs_of_training_framework_tpu'},
        tmp_path)
    assert done.returncode == 0, done.stderr[-3000:]
    assert 'EXIT 0 PORT True FOUND []' in done.stdout, done.stdout[-2000:]


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    done = run_python('''
        import torch
        from harness import check, flops, peaks, reference, spec, traffic
        from harness import weights
        bench = spec.load_benchmark()
        for cell in bench['workloads']:
            cell = spec.Cell(bench, cell['name'])
            model = cell.reference().build(cell.config, lambda x: x)
            weights.make(model, 1, torch.device('cpu'))
        print('LOADED', sorted({m.split('.')[0] for m in sys.modules}
                               & {'dvs_of_training_framework_tpu_torch',
                                  'jax', 'dvs_of_training_framework_tpu'}))
    ''', {'jax', 'jaxlib', 'flax', 'dvs_of_training_framework_tpu',
          'dvs_of_training_framework_tpu_torch'}, tmp_path)
    assert done.returncode == 0, done.stderr[-3000:]
    assert 'LOADED []' in done.stdout
