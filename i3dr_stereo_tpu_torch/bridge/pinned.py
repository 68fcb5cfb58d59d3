"""Page-locked host buffers for the graph node's outputs, reused once
every array published from them is gone.

``.cpu()`` of a device tensor copies into fresh pageable memory: the
CUDA runtime stages the copy through a page-locked buffer of its own on the
host's CPU, the new array's pages are faulted in, and they are unmapped
again when it dies. A copy into page-locked memory is one DMA that the
host only enqueues. :class:`PinnedPool` keeps such buffers by shape and
dtype; :meth:`PinnedPool.copy` enqueues a tensor's copy into one and
returns the numpy view to publish. The buffer goes back to the pool when
the last reference to that array, or to any view of it, dies
(``weakref.finalize``, on whichever thread drops it), so no buffer is
written while a subscriber still holds what was published from it.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

# the idle buffers kept for one (shape, dtype); more are freed. Two
# frames of the node's outputs, at most four of one key each (the
# rectified pair, disparity and depth): a subscriber may drop a frame it
# kept while the topics' latch lets go of the last one
FREE_PER_KEY = 8


def page_locked(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """A page-locked host tensor (needs a CUDA device)."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class PinnedPool:
    """Host buffers by ``(shape, dtype)`` from ``alloc(shape, dtype)``
    (page-locked unless a caller passes another allocator), lent out as
    numpy arrays and taken back when those arrays die."""

    def __init__(self, alloc=page_locked):
        self._alloc = alloc
        self._free: dict = {}
        # reentrant: a finalizer may run on the thread that holds it (a
        # collection triggered inside)
        self._lock = threading.RLock()

    @property
    def idle(self) -> int:
        """Buffers held for reuse."""
        with self._lock:
            return sum(len(v) for v in self._free.values())

    def copy(self, x: torch.Tensor) -> tuple[np.ndarray, int]:
        """``x``'s copy enqueued (``non_blocking``) into a buffer of the
        pool, and the bytes newly allocated for it (0 where the pool held
        a free buffer). The array's contents are ``x``'s once the copy's
        stream has reached it: wait on that stream before reading it."""
        key = (tuple(x.shape), x.dtype)
        with self._lock:
            free = self._free.get(key)
            buf = free.pop() if free else None
        fresh = 0
        if buf is None:
            buf = self._alloc(key[0], x.dtype)
            fresh = buf.numel() * buf.element_size()
        buf.copy_(x, non_blocking=True)
        out = buf.numpy()
        weakref.finalize(out, self._give_back, key, buf)
        return out, fresh

    def _give_back(self, key, buf: torch.Tensor) -> None:
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < FREE_PER_KEY:
                free.append(buf)
