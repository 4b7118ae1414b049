"""Text metrics utilities: Levenshtein distance/opcodes, basic normalizer.

Native replacements for the reference's ``Levenshtein`` package
(``calculate_wer.py:10,65,86``: ``opcodes`` with the op vocabulary
equal/replace/delete/insert) and espnet's ``TextCleaner("whisper_basic")``
(Whisper's BasicTextNormalizer: lowercase, strip text in brackets, drop
punctuation/symbol/mark characters, collapse whitespace).
"""

from __future__ import annotations

import re
import unicodedata

__all__ = ["levenshtein_distance", "opcodes", "whisper_basic_normalize"]


def levenshtein_distance(a, b) -> int:
    """Edit distance over arbitrary hashable sequences."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def opcodes(a, b):
    """Minimal-edit opcodes (op, a_start, a_end, b_start, b_end) matching the
    python-Levenshtein vocabulary: equal/replace/delete/insert.

    Dynamic-programming traceback over the full distance matrix; adjacent
    same-op spans are merged.
    """
    n, m = len(a), len(b)
    # distance matrix
    dist = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dist[i][0] = i
    for j in range(m + 1):
        dist[0][j] = j
    for i in range(1, n + 1):
        ai = a[i - 1]
        row = dist[i]
        prow = dist[i - 1]
        for j in range(1, m + 1):
            row[j] = min(
                prow[j] + 1, row[j - 1] + 1, prow[j - 1] + (ai != b[j - 1])
            )
    # traceback
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and a[i - 1] == b[j - 1] and dist[i][j] == dist[i - 1][j - 1]:
            ops.append(("equal", i - 1, i, j - 1, j))
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dist[i][j] == dist[i - 1][j - 1] + 1:
            ops.append(("replace", i - 1, i, j - 1, j))
            i, j = i - 1, j - 1
        elif i > 0 and dist[i][j] == dist[i - 1][j] + 1:
            ops.append(("delete", i - 1, i, j, j))
            i = i - 1
        else:
            ops.append(("insert", i, i, j - 1, j))
            j = j - 1
    ops.reverse()
    # merge adjacent same-op spans
    merged = []
    for op in ops:
        if merged and merged[-1][0] == op[0] and merged[-1][2] == op[1] and merged[-1][4] == op[3]:
            merged[-1] = (op[0], merged[-1][1], op[2], merged[-1][3], op[4])
        else:
            merged.append(op)
    return merged


_BRACKETS = re.compile(r"[<\[][^>\]]*[>\]]|\([^)]+?\)")


def whisper_basic_normalize(s: str) -> str:
    """Whisper BasicTextNormalizer: lowercase, remove bracketed text, drop
    characters in Unicode categories M/S/P, collapse whitespace."""
    s = s.lower()
    s = _BRACKETS.sub("", s)
    # NFKC like Whisper (NOT NFKD: decomposition would turn precomposed
    # accented letters into base + combining mark, and the mark — category
    # Mn — would become a space, splitting 'naïve' into 'nai ve')
    s = "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )
    return re.sub(r"\s+", " ", s).strip()
