"""Deterministic, PYTHONHASHSEED-independent seed derivation.

Every fault campaign derives its keys from :func:`stable_seed` over
named parts, so the same campaign reproduces bitwise across processes
and Python versions (``hash()`` is salted per process; ``zlib.crc32``
is not), and draws the same keys as the reference's campaigns.
"""
from __future__ import annotations

import zlib


def stable_seed(*parts) -> int:
    """Deterministic 31-bit seed from string-able parts (crc32, not
    ``hash()``)."""
    return zlib.crc32("|".join(map(str, parts)).encode()) % (2**31)
