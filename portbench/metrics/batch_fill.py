"""Lanes that carried a request, over all lanes of the window's batches
(``EngineStats.served`` over batches × slots), in percent."""


def read(run):
    b = run.batches
    return 100.0 * sum(x.served for x in b) / (len(b) * run.record.slots) if b else None
