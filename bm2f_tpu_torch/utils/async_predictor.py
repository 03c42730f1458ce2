"""Overlapped host/device inference pipeline (reference:
demo/predictor.py:131-199 `AsyncPredictor`; a copy of the JAX package's
`bm2f_tpu/utils/async_predictor.py`).

The reference overlaps visualization with inference by spawning one
`_PredictWorker` process per GPU connected by task/result multiprocessing
queues. On one card the same overlap comes from a 3-stage THREAD pipeline,
since CUDA launches are asynchronous: the device works on item i while the
host preprocesses item i+1 and postprocesses item i-1:

  loader thread:  item -> preprocess(item)   (file IO, numpy pad, at most a
                                              copy into pinned host memory;
                                              no CUDA launch)
  caller thread:  predict_fn(inputs)         (launches the forward and
                                              returns device tensors: no
                                              .cpu(), .item(), .tolist() or
                                              nonzero, which would wait for
                                              the device)
  caller thread:  postprocess(item, outputs) of the OLDEST in-flight item
                                             (the copies to the host: the
                                              pipeline's sync point)

Results are yielded strictly in submission order (the reference tracks
put/get indices for the same guarantee, predictor.py:178-196)."""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Tuple


class AsyncPredictor:
    """predict_fn: device inference taking preprocess's output;
    preprocess: host-side item -> model input (runs in the loader thread);
    postprocess: device output -> host result (runs in the caller thread,
    materializing device arrays = the pipeline's sync point);
    depth: in-flight device batches (2 = double buffering)."""

    _STOP = object()

    def __init__(self, predict_fn: Callable, preprocess: Callable,
                 postprocess: Callable = lambda item, out: out,
                 depth: int = 2, queue_size: int = 4):
        self.predict_fn = predict_fn
        self.preprocess = preprocess
        self.postprocess = postprocess
        self.depth = max(1, depth)
        self.queue_size = queue_size

    def __call__(self, items: Iterable[Any]) -> Iterator[Tuple[Any, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        err: list = []
        stop = threading.Event()

        def put(x) -> bool:
            """Blocks on a full queue until there is room or the consumer
            has gone (False)."""
            while not stop.is_set():
                try:
                    q.put(x, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def loader():
            try:
                for item in items:
                    if stop.is_set() or not put((item, self.preprocess(item))):
                        return
            except BaseException as e:  # noqa: BLE001 — surface in caller
                err.append(e)
            finally:
                put(self._STOP)

        t = threading.Thread(target=loader, daemon=True)
        t.start()

        inflight: list = []
        try:
            while True:
                got = q.get()
                if got is self._STOP:
                    break
                item, inputs = got
                inflight.append((item, self.predict_fn(inputs)))
                if len(inflight) >= self.depth:
                    it, out = inflight.pop(0)
                    yield it, self.postprocess(it, out)
            for it, out in inflight:
                yield it, self.postprocess(it, out)
            inflight = []
        finally:
            # a consumer that abandons the generator early (or an error in
            # the caller) stops the loader at its next item and drains the
            # queue, so that it does not block on a full queue forever
            # (bounded: if preprocess itself is slow we give up after 10 s
            # and leave the daemon thread to die with the process). The JAX
            # package's loader preprocesses every remaining item first.
            stop.set()
            deadline = time.monotonic() + 10.0
            while t.is_alive() and time.monotonic() < deadline:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
        if err:
            raise err[0]
