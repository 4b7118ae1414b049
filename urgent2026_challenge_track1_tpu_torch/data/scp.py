"""Kaldi-style scp readers (counterpart of ``data/scp.py``)."""

from __future__ import annotations

from collections import defaultdict

__all__ = ["read_kv_scp", "read_source_scp"]


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


def read_source_scp(scp: str):
    """``uid fs path`` lines -> (fs-keyed dict of {uid: path}, fs-keyed uid
    lists, flat {uid: path}); a uid listed twice at one fs raises."""
    source_dict = defaultdict(dict)
    flat = {}
    with open(scp, "r", encoding="utf-8") as f:
        for line in f:
            uid, fs, path = line.strip().split()
            fs = int(fs)
            if uid in source_dict[fs]:
                raise ValueError(f"{scp}: duplicate uid {uid} at {fs} Hz")
            source_dict[fs][uid] = path
            flat[uid] = path
    uids = {k: list(source_dict[k].keys()) for k in source_dict}
    return dict(source_dict), uids, flat
