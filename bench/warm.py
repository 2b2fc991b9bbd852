"""Bringing the card's host link to its loaded state before a score window.

On the H100 machines this benchmark runs on, a process's first seconds ran
slower until, after 2 to 22 s, they switched to a fast state for good: graph
replays took ~0.34 us more per node, and the score cell's pageable
host-to-device copies ran slow, so that its 51-s windows spread by 14-24%
between runs against 5-6% with this warm-up.  Two seconds of bulk copies
each way between pinned host memory and the card switch the state at once.
A score cell stands for offline scoring of recorded runs, a job of hours
that spends its life in the fast state, so its set-up ends with those
copies.  The train cells take none: the Pareto sweep at B = 1024 lasts
seconds, inside the slow state, so they measure it.
"""

from __future__ import annotations

import time

import torch

WARM_S = 2.0
WARM_BYTES = 256 << 20


def link(device, seconds: float = WARM_S) -> int:
    """``seconds`` of back-to-back copies host to card and back (a CUDA
    device only).  Returns the device's peak allocated bytes before them;
    the peak is reset after them, so that their buffer counts in no peak."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    host = torch.empty(WARM_BYTES, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(WARM_BYTES, dtype=torch.uint8, device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        card.copy_(host, non_blocking=True)
        host.copy_(card, non_blocking=True)
        torch.cuda.synchronize(device)
    del host, card
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return peak
