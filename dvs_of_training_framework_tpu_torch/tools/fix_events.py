#!/usr/bin/env python3
"""Repair TensorBoard event files after restarts.

The port's entry point after ``scripts/fix_events.py``, over the port's
TFRecord codec (``utils/tb.py``).  A resumed run replays a span of
steps, which leaves non-monotonic ``samples_passed`` steps in a log that
holds both runs' records.  This drops every record that a later restart
overrides and rewrites the file, keeping the original beside it as
``<file>.orig``.

Usage:
    python -m dvs_of_training_framework_tpu_torch.tools.fix_events \
        <log_dir_or_event_file> [...]
"""
from pathlib import Path
import shutil
import sys

from ..utils.tb import decode_event, read_records, write_records


def fix_records(records):
    """Drop records whose step is overridden by a later restart.

    A restart rewinds the step counter; every earlier record with
    ``step >= restart_step`` is stale.  Scanning from the end keeps the
    final (authoritative) history.
    """
    decoded = [(rec, decode_event(rec)) for rec in records]
    kept = []
    min_step = {}  # per tag: smallest step kept so far (scanning backward)
    for rec, event in reversed(decoded):
        if not event['scalars']:
            kept.append(rec)  # metadata records (file version) stay
            continue
        tags = event['scalars'].keys()
        if all(tag not in min_step or event['step'] < min_step[tag]
               for tag in tags):
            for tag in tags:
                min_step[tag] = event['step']
            kept.append(rec)
    return list(reversed(kept))


def fix_file(path):
    records = list(read_records(path))
    fixed = fix_records(records)
    if len(fixed) == len(records):
        print(f'{path}: already monotonic ({len(records)} records)')
        return
    backup = Path(str(path) + '.orig')
    if not backup.exists():
        shutil.copyfile(path, backup)
    write_records(path, fixed)
    print(f'{path}: kept {len(fixed)}/{len(records)} records '
          f'(backup at {backup.name})')


def main(paths=None):
    for arg in sys.argv[1:] if paths is None else paths:
        p = Path(arg)
        files = [p] if p.is_file() else sorted(p.glob('events.out.*'))
        if not files:
            print(f'{p}: no event files found')
        for f in files:
            if f.suffix == '.orig':
                continue
            fix_file(f)


if __name__ == '__main__':
    main()
