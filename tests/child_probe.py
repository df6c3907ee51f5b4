"""A ``sitecustomize`` for the children of the port's accuracy scripts.

``tests/test_torch_accuracy_scripts.py`` and ``chip_smoke.py`` copy this
file as ``sitecustomize.py`` into a directory first on the children's
``PYTHONPATH``, so every ``python -m`` child of the scripts loads it at
start.  When the child exits it writes ``<PROBE_DIR>/<pid>.json``: its
``argv``, the port's kernel launch counts (``ops.launch_counts()``, or
null where the child never imported ``ops``) and, under ``foreign``,
every module it loaded of jax, flax, optax or the JAX package, or from
a file of the checkout at ``PROBE_REPO`` outside the port's package
(the root plugins and CLIs, ``scripts/``).
"""
import atexit
import json
import os
import sys

REPO = os.path.realpath(os.environ['PROBE_REPO'])
PORT = os.path.join(REPO, 'dvs_of_training_framework_tpu_torch')
JAX_SIDE = ('jax', 'flax', 'optax', 'dvs_of_training_framework_tpu')


def _outside_port(module):
    path = getattr(module, '__file__', None)
    if not isinstance(path, str) or not os.path.isabs(path):
        return False
    path = os.path.realpath(path)
    return path.startswith(REPO + os.sep) and not path.startswith(
        PORT + os.sep)


def _probe():
    ops = sys.modules.get('dvs_of_training_framework_tpu_torch.ops')
    record = {'argv': sys.argv,
              'launches': None if ops is None else ops.launch_counts(),
              'foreign': sorted(
                  name for name, m in list(sys.modules.items())
                  if m is not None and (name.split('.')[0] in JAX_SIDE
                                        or _outside_port(m)))}
    path = os.path.join(os.environ['PROBE_DIR'], f'{os.getpid()}.json')
    with open(path, 'w') as f:
        json.dump(record, f)


atexit.register(_probe)
