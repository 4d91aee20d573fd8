"""Background batch producer.

Port of ``PrefetchLoader`` from :mod:`pdc_tpu.data.native_loader`
(:191-262): a host thread assembles batch k+1 while the device runs step
k. The native PNG decoder of that module waits for the on-disk data slice.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class _ProducerError:
    """Sentinel carrying a producer-thread exception through the queue."""

    def __init__(self, exc):
        self.exc = exc


class PrefetchLoader:
    """Double-buffered background batch producer.

    Wraps a zero-argument ``make_batch`` (for example
    ``lambda: dataset.make_host_batch(B)``) with a worker thread that keeps
    up to ``depth`` batches ready. A failure in ``make_batch`` is raised by
    :meth:`next` as a ``RuntimeError`` chained to it, never a hang.
    """

    def __init__(self, make_batch, depth: int = 2, device=None):
        """:param device: when given, the worker thread also copies each
        numpy array of the batch to this device, so the copy overlaps the
        device's current step; None keeps the batch on the host."""
        self._make_batch = make_batch
        self._device = None if device is None else torch.device(device)
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
                if self._device is not None:
                    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
                             if isinstance(v, np.ndarray) else v for k, v in batch.items()}
            except BaseException as exc:  # handed to the consumer, which re-raises
                self._put(_ProducerError(exc))
                return
            self._put(batch)

    def next(self):
        item = self._q.get()
        if isinstance(item, _ProducerError):
            self.stop()
            raise RuntimeError("PrefetchLoader producer thread failed") from item.exc
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
