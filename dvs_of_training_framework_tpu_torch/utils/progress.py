"""Progress bars where tqdm is installed, and none where it is not (the
card's machine has no tqdm)."""


class _Silent:
    """What the port uses of a tqdm bar, drawing nothing."""

    def __init__(self, iterable=None):
        self._iterable = iterable

    def __iter__(self):
        return iter(self._iterable)

    def update(self, n=1):
        pass

    def close(self):
        pass


def progress(iterable=None, **kwargs):
    """A tqdm progress bar where tqdm is installed, else a silent one."""
    try:
        import tqdm
    except ImportError:
        return _Silent(iterable)
    return tqdm.tqdm(iterable, **kwargs)
