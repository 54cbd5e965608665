"""Tensors that a captured CUDA graph reads but does not own.

A CUDA graph replays the device addresses it saw while it was captured. A
cached table (a resize matrix, a RoPE or sine table) that a captured step
reads was made before the capture, outside the graph's memory pool; if its
cache dropped it, the graph would read memory that another tensor had
taken. The functions that hand out such tables pass them through `held`,
and a capture inside `holding()` gets the list of every table that passed,
to keep beside the graph for as long as the graph lives.

A table derived from a tensor that a write can change (the W8A8 levels of
a weight) names that tensor as its `source`: the list keeps the source's
version as the capture saw it, and `stale()` tells once a write has moved
it, so that the graph, which replays the old table, is dropped.
"""
import contextlib
import contextvars

__all__ = ["Held", "held", "holding"]

# a contextvar, not a module global, so that a capture in one thread does
# not collect the tables of another
_HELD = contextvars.ContextVar("nttt_torch_graph_held", default=None)


class Held(list):
    """The tables handed out inside a `holding()`, and `sources`: (tensor,
    version) of each table's source."""

    def __init__(self):
        super().__init__()
        self.sources = []

    def stale(self):
        """Whether a source was written since its table was handed out."""
        return any(t._version != v for t, v in self.sources)


def held(table, source=None):
    """Return `table`, and add it (and its `source`'s version) to the list
    of an open `holding()`."""
    keep = _HELD.get()
    if keep is not None:
        keep.append(table)
        if source is not None:
            keep.sources.append((source, source._version))
    return table


@contextlib.contextmanager
def holding():
    """Collect, in the `Held` list it yields, every table handed out
    inside."""
    keep = Held()
    tok = _HELD.set(keep)
    try:
        yield keep
    finally:
        _HELD.reset(tok)
