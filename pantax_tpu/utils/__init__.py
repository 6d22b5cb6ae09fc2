import os

from .cache import enable_compilation_cache


def pipeline_depth() -> int:
    """In-flight device batch queue depth for pipelined dispatch/collect
    loops: several outstanding batches keep the device occupied across each
    dispatch->result round trip; override with PANTAX_TPU_PIPELINE_DEPTH."""
    return int(os.environ.get("PANTAX_TPU_PIPELINE_DEPTH", "4"))


def prefetched(prep, items, depth: int = 2):
    """Yield ``(item, prep(item))`` in order, with ``prep`` (batch pack +
    uploads) running up to ``depth`` items ahead on ONE worker thread so
    the uploads overlap device compute and the main thread's blocking result
    downloads instead of serializing between dispatches.  Dispatch order —
    and therefore every result — is identical to the inline loop.
    PANTAX_TPU_PREFETCH=0 restores the inline path for A/B probes."""
    items = list(items)
    if os.environ.get("PANTAX_TPU_PREFETCH", "1") == "0" or len(items) <= 1:
        for it in items:
            yield it, prep(it)
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="wire-prep") as ex:
        # Pop consumed futures so each batch's uploaded wire buffers are
        # released after dispatch instead of accumulating for the whole run
        # (large deletion bursts at loop end stall the host).
        futs = deque(ex.submit(prep, it) for it in items[:depth])
        for i, it in enumerate(items):
            if i + depth < len(items):
                futs.append(ex.submit(prep, items[i + depth]))
            yield it, futs.popleft().result()


__all__ = ["enable_compilation_cache", "pipeline_depth", "prefetched"]
