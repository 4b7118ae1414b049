"""Checkpoints, the parameter bridge, audio I/O (WAV, FLAC) and the host C++
libraries of the simulation."""
