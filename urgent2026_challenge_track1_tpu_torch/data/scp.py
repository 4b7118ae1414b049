"""Kaldi-style scp reader (counterpart of ``data/scp.py``)."""

from __future__ import annotations

__all__ = ["read_kv_scp"]


def read_kv_scp(scp: str) -> dict[str, str]:
    """``uid value`` lines -> dict; a duplicate uid raises."""
    rtv = {}
    with open(scp, "r", encoding="utf-8") as f:
        for line in f:
            uid, value = line.strip().split()
            if uid in rtv:
                raise ValueError(f"{scp}: duplicate uid {uid}")
            rtv[uid] = value
    return rtv
