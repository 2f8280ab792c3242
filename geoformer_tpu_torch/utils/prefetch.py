"""Host-side batch prefetching (reference DataLoader workers,
num_workers 1-6 in config/*.yaml).

Scene assembly (load + augment + elastic + crop + pad) is host-heavy at
250k points; `prefetch` runs the generator in a worker thread so the next
batches build while the device steps. The port's copy of
geoformer_tpu/utils/prefetch.py.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class _Stop:
    pass


def prefetch(gen: Iterable, depth: int = 2) -> Iterator:
    """Wrap a generator: pull items in a background thread, buffer `depth`.

    depth <= 0 returns the generator unchanged (num_workers=0 semantics).
    Exceptions in the producer propagate to the consumer.
    """
    if depth <= 0:
        return iter(gen)

    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # noqa: BLE001
            err.append(e)
        finally:
            q.put(_Stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def consumer():
        while True:
            item = q.get()
            if item is _Stop:
                if err:
                    raise err[0]
                return
            yield item

    return consumer()
