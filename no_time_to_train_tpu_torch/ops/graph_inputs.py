"""Tensors that a captured CUDA graph reads but does not own.

A CUDA graph replays the device addresses it saw while it was captured. A
cached table (a resize matrix, a RoPE or sine table) that a captured step
reads was made before the capture, outside the graph's memory pool; if its
cache dropped it, the graph would read memory that another tensor had
taken. The functions that hand out such tables pass them through `held`,
and a capture inside `holding()` gets the list of every table that passed,
to keep beside the graph for as long as the graph lives.
"""
import contextlib
import contextvars

__all__ = ["held", "holding"]

# a contextvar, not a module global, so that a capture in one thread does
# not collect the tables of another
_HELD = contextvars.ContextVar("nttt_torch_graph_held", default=None)


def held(table):
    """Return `table`, and add it to the list of an open `holding()`."""
    keep = _HELD.get()
    if keep is not None:
        keep.append(table)
    return table


@contextlib.contextmanager
def holding():
    """Collect, in the list it yields, every table handed out inside."""
    keep = []
    tok = _HELD.set(keep)
    try:
        yield keep
    finally:
        _HELD.reset(tok)
