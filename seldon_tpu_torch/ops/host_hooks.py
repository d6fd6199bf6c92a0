"""Host callbacks of a captured body: the port's ``jax.debug.callback``.

A kernel wrapper, the model or an instrumentation tap that counts or
records something on the host calls :func:`host_callback` where it
launches its work. On the eager route the callback runs at once. While
a body is captured as a CUDA graph (``servers/wave_program.py``), the
capture collects the callback and runs it after every replay, so a
replayed program counts what its body launched; it sees the values the
replay left in the tensors it holds. A capture's eager warm run drops
callbacks: its launches settle one-time work and are not counted.

The collecting side (:func:`collecting`) is the capture's; it is a
thread-local, so another thread's eager work runs its callbacks at once
while this thread captures.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Union

_tls = threading.local()


class _Drop:
    """The collector of a capture's warm run: drops every callback."""


# Pass to :func:`collecting` for a capture's warm run.
WARM = _Drop()


def host_callback(fn: Callable[[], Any]) -> None:
    """Run ``fn`` on the host where the body is: now on the eager route;
    after every replay while a body is being captured on this thread;
    never during a capture's warm run."""
    hooks = getattr(_tls, "hooks", None)
    if hooks is None:
        fn()
    elif hooks is not WARM:
        hooks.append(fn)


@contextlib.contextmanager
def collecting(hooks: Union[List[Callable[[], Any]], _Drop]):
    """On this thread, :func:`host_callback` appends to ``hooks`` (a
    capture), or drops its callback (``WARM``)."""
    prev = getattr(_tls, "hooks", None)
    _tls.hooks = hooks
    try:
        yield
    finally:
        _tls.hooks = prev
