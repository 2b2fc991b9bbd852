"""Faults planted in the program underneath a run, for the readings that a
limit is set from and for the tests that see the check catch them."""

import contextlib


@contextlib.contextmanager
def stale_graph_batches():
    """Every replay of a captured training chunk reads the rows it was
    captured with: the chunk's staged batch is never refilled."""
    from repro_torch.train import loop

    orig = loop._GraphChunk.__call__

    def call(self, opt_state, batches):
        cap = self.captured.get(loop._chunk_len(batches))
        return orig(self, opt_state, batches if cap is None else cap.batches)

    loop._GraphChunk.__call__ = call
    try:
        yield
    finally:
        loop._GraphChunk.__call__ = orig
