"""Checkpoints, the parameter bridge, audio I/O (WAV, FLAC), the host C++
libraries of the simulation, and ``capped_nj``."""


def capped_nj(nj: int) -> int:
    """Worker-pool size capped at the host's CPU count: a spawn pool larger
    than the core count only adds start-up and IPC cost."""
    import os

    return min(nj, os.cpu_count() or 1)
