"""The comparison that decides ``correct``.

Two windows of the program (``window`` steps each, one fused call of the
timed path), each against the plain reference trained in float32 over
the same batches from the same state: the first window, from the seeded
weights and a fresh optimizer, and the check window after the timed (and
traced) windows, from the program's own parameters and optimizer state
before it (``late_``: past the warm-up of the learning rate, with the
next window staged behind a replay, as in the timed window).  The
numbers, each against its limit from the configuration file
(``correct``):

- ``loss_gap``: the largest relative gap of a step's loss; in the check
  window ``loss_gap_median``, the median over its steps, since there the
  largest takes the one batch in sixteen or so on which the bf16 loss
  lands farthest from the float32 one (0.01-0.19, the other steps
  0.0001-0.01), and so swings from seed to seed;
- ``change_gap``: the worst leaf's gap between the norms of the
  parameters' change over the window, ``| |dp| - |dp_ref| |``, over the
  larger of ``|dp_ref|`` and the median leaf's; in the check window
  ``change_gap_median``, the median leaf's, since there the worst is a
  small leaf that follows the few batches on which bf16 lands far;
- ``moment_gap``: the same of the optimizer's first moment after the
  first window, the gradients as the optimizer got them (the fused
  window keeps no state between its steps, so the first step's gradient
  is not there to read).  The check window's moment is not compared:
  after 16 steps it is mostly the last few batches' gradients, and
  neither its worst nor its median leaf tells the float32 reference's
  fp8 control from sound bf16 runs.

A leaf whose reference gradient is nought to rounding (its first moment
under a thousandth of the median leaf's, as gradient centralisation
leaves a ``[1, n]`` kernel) is left out of the leaf numbers.
"""
import math
import statistics

NAMES = ('loss_gap', 'change_gap', 'moment_gap', 'late_loss_gap_median',
         'late_change_gap_median')
NOUGHT = 1e-3


def _norm(t):
    return float(t.double().norm())


def leaf_gaps(got, want, leaves):
    """Each leaf's ``| |got| - |want| |`` over ``max(|want|, median
    |want|)``, over ``leaves``: ``{leaf: (gap, |got|, |want|)}``."""
    norms = {k: _norm(want[k]) for k in leaves}
    floor = statistics.median(norms.values())
    gaps = {}
    for k in leaves:
        got_norm = _norm(got[k])
        gap = abs(got_norm - norms[k]) / max(norms[k], floor)
        gaps[k] = (gap if math.isfinite(gap) else math.inf, got_norm,
                   norms[k])
    return gaps


def worst_leaves(gaps, n=5):
    """The ``n`` leaves of ``leaf_gaps`` with the largest gaps."""
    return sorted(([k, *v] for k, v in gaps.items()),
                  key=lambda row: -row[1])[:n]


def loss_gaps(losses, reference):
    """Each step's relative loss gap, ``inf`` for a step the program did
    not report or reported as not finite."""
    if len(losses) < len(reference):
        return [math.inf] * len(reference)
    return [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(losses, reference)]


def numbers(program, reference, start, prefix='', detail=None):
    """A window's numbers, named with ``prefix``, from ``program``
    and ``reference`` (``{'loss': [per step], 'params': {...}, 'mu':
    {...}}``) and ``start``, the weights the window started from, all on
    the CPU: the worst step's and the median step's loss gap, and the
    worst leaf's and the median leaf's change and moment gap.
    ``detail``, where given, gets each leaf number's worst leaves."""
    gaps = loss_gaps(program['loss'], reference['loss'])
    moment = {k: _norm(m) for k, m in reference['mu'].items()}
    median = statistics.median(moment.values())
    leaves = [k for k, v in moment.items() if v >= NOUGHT * median]
    change = {k: program['params'][k] - start[k] for k in leaves}
    change_ref = {k: reference['params'][k] - start[k] for k in leaves}
    values = {prefix + 'loss_gap': max(gaps),
              prefix + 'loss_gap_median': statistics.median(gaps)}
    for name, got, want in (('change', change, change_ref),
                            ('moment', program['mu'], reference['mu'])):
        by_leaf = leaf_gaps(got, want, leaves)
        values[prefix + name + '_gap'] = max(g for g, _, _ in
                                             by_leaf.values())
        values[prefix + name + '_gap_median'] = statistics.median(
            g for g, _, _ in by_leaf.values())
        if detail is not None:
            detail[prefix + name + '_leaves'] = worst_leaves(by_leaf)
    return values


def verdict(values, limits):
    """``correct``: every number finite and at most its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in NAMES)


def lines(values, limits):
    """One line a number: its name, its value and its limit."""
    return [f'{k} {values[k]!r} limit {limits[k]!r}' for k in NAMES]
