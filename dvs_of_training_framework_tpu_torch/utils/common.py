"""Shared helpers: cumulative sums, run provenance, data roots.

Parity targets in the reference: utils/common.py (cumsum_with_prefix 26-50,
provenance 97-237, mean 22-23, to_tensor 240-259).
The TPU build keeps host-side batch assembly in NumPy, so these helpers are
NumPy-first; ``to_array`` replaces torch ``to_tensor``.

The port's copy of ``dvs_of_training_framework_tpu/utils/common.py``.  It
writes the provenance document as JSON (which YAML readers read too), so
it needs no PyYAML for its own runs; a YAML document of an older run is
read with PyYAML imported inside the parser.  It records no revision
where ``git`` is not installed.
"""
import json
import os
from pathlib import Path
import re
import subprocess
import sys
from typing import Dict, Union

import numpy as np


def data_root(variable):
    """The data directory named by the environment variable ``variable``.

    The JAX package falls back to a docker mount or to a ``data/``
    directory beside the checkout; the port reads nothing outside its
    checkout unless told, so it requires the variable.
    """
    root = os.environ.get(variable)
    if not root:
        raise RuntimeError(f'${variable} is not set: point it at the data '
                           'directory')
    return Path(root)


def mean(values):
    values = list(values)
    return sum(values) / len(values)


def cumsum_with_prefix(arr, dtype=None):
    """Cumulative sum of a 1-d array shifted by one: [1,2,3] -> [0,1,3,6]."""
    arr = np.asarray(arr)
    if dtype is None:
        dtype = arr.dtype
    result = np.zeros(arr.size + 1, dtype=dtype)
    np.cumsum(arr, dtype=dtype, out=result[1:])
    return result


def get_commithash(cwd=None):
    """Git commit hash of the repo at ``cwd`` (default: current directory)."""
    done = subprocess.run(['git', 'rev-parse', '--verify', 'HEAD'],
                          cwd=cwd, check=True, capture_output=True)
    return done.stdout.decode().strip()


# --- Run provenance ---------------------------------------------------------
#
# Every output directory carries a self-describing ``parameters`` file (one
# structured JSON document: command line, git revisions of the framework and
# the model plugin, full argument set).  On resume the stored document is
# compared against the current run so a checkpoint is never silently
# continued with different code or different hyper-parameters — the same
# safety gate as reference utils/common.py:97-237, redesigned around a
# single JSON document instead of a delimited text format.

PROVENANCE_FILENAME = 'parameters'

# Arguments that may differ between a run and its resume without
# invalidating the output directory.
_VOLATILE_ARGS = {'allow_arguments_change', 'allow_obsolete_code',
                  'cache-dir', 'cache_dir'}


def _yaml_friendly(value):
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, tuple):
        return list(value)
    return value


def _optional_commithash(cwd=None):
    try:
        return get_commithash(cwd)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None


def collect_execution_info(args):
    """Build the provenance document for the current run (a JSON
    string)."""
    revisions = {'framework': _optional_commithash()}
    plugin_dir = vars(args).get('flownet_path')
    if plugin_dir is not None:
        plugin_hash = _optional_commithash(plugin_dir)
        # in-tree plugins share the framework repository; only record a
        # separate revision when the plugin is its own checkout
        if plugin_hash is not None and plugin_hash != revisions['framework']:
            revisions['model'] = plugin_hash
    document = {
        'command': ' '.join(sys.argv),
        'revisions': revisions,
        'arguments': {k: _yaml_friendly(v) for k, v in vars(args).items()},
    }
    return json.dumps(document, indent=1, default=str)


def file_for_execution_info(out_dir):
    return Path(out_dir) / PROVENANCE_FILENAME


def write_execution_info(out_dir, execution_info):
    file_for_execution_info(out_dir).write_text(execution_info)


def read_execution_info(out_dir):
    path = file_for_execution_info(out_dir)
    return path.read_text() if path.is_file() else None


def _parse_execution_info(execution_info):
    try:
        document = json.loads(execution_info)
    except json.JSONDecodeError:
        # a YAML document, as the JAX package and the port before its
        # JSON provenance wrote them
        import yaml
        document = yaml.safe_load(execution_info)
    if not isinstance(document, dict) or 'arguments' not in document:
        raise ValueError('unrecognised provenance document format')
    return document


def execution_info2code_revisions(execution_info):
    return _parse_execution_info(execution_info).get('revisions', {})


def execution_info2args(execution_info):
    return _parse_execution_info(execution_info)['arguments']


def _assert_shared_entries_match(stored, current, skip, describe):
    for key in sorted(set(stored) & set(current) - skip):
        assert stored[key] == current[key], \
            f'Stored and current {describe} {key} are different ' \
            f'({stored[key]} vs {current[key]})'


def check_execution_info(out_dir, execution_info, args):
    """Resume-safety gate: assert code revisions and args are unchanged.

    Overridable via --allow-obsolete-code / --allow-arguments-change
    (reference utils/common.py:205-237).
    """
    stored_info = read_execution_info(out_dir)
    if stored_info is None:
        return
    stored = _parse_execution_info(stored_info)
    current = _parse_execution_info(execution_info)
    if not getattr(args, 'allow_obsolete_code', False):
        _assert_shared_entries_match(
            stored.get('revisions', {}), current.get('revisions', {}),
            skip=set(), describe='revisions for repository')
    if not getattr(args, 'allow_arguments_change', False):
        _assert_shared_entries_match(
            stored['arguments'], current['arguments'],
            skip=_VOLATILE_ARGS, describe='value for argument')


def to_array(data: Union[np.ndarray, Dict, list, float]):
    """Convert nested data to NumPy arrays (int -> int64, rest -> float32).

    Host-side replacement for the reference ``to_tensor``
    (utils/common.py:240-259): integer inputs stay integral (int64),
    everything else becomes float32.
    """
    if isinstance(data, dict):
        return {k: to_array(v) for k, v in data.items()}
    arr = np.asarray(data)
    if arr.dtype == np.int_ or np.issubdtype(arr.dtype, np.integer) \
            or arr.dtype == np.bool_:
        if arr.dtype == np.bool_:
            return arr
        return arr.astype(np.int64)
    return arr.astype(np.float32)


def parse_template(template: str, value: str):
    """Minimal stand-in for ``parse.parse`` restricted to '{}' templates.

    Returns a list of captured groups or None when the value does not match.
    Used by the checkpoint serializer to rediscover checkpoints by name.
    """
    pattern = re.escape(template).replace(r'\{\}', '(.+?)')
    m = re.fullmatch(pattern, value)
    if m is None:
        return None
    return list(m.groups())
