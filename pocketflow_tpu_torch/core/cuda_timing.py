"""The card's name and power limit, and device time by CUDA events: the two
helpers every timed run of the port prints and measures with."""

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, by CUDA
    events, after one call and a synchronize."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
