"""chunks_per_batch: the chunks the batch tool ran a stack in on the card,
a batch on average: the port's ``batch_chunks`` counter over the calls of
its ``batch`` span, in the traced sub-window. Nothing where the port
counts no chunk."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    chunks, batch = (_port.counter(snap, "batch_chunks"),
                     _port.span(snap, "batch"))
    return None if chunks is None or batch is None else chunks / batch[0]
