"""Shared arithmetic of the ``shard.*`` readers: the NCCL all-reduce
kernels' device time in a profiled slice, and one card's NVLink
bandwidth as read on the card (``workcount/h100_nvlink.json``)."""

from __future__ import annotations

import json
import pathlib

NVLINK = pathlib.Path(__file__).resolve().parent / "workcount" / "h100_nvlink.json"


def allreduce_s(p) -> float:
    """Seconds of NCCL all-reduce kernels in the slice ``p`` (0 without
    a slice or without such a kernel)."""
    if p is None:
        return 0.0
    return sum(e - s for n, s, e in p.device_ops
               if n.startswith("nccl") and "AllReduce" in n) / 1e9


def link_bytes_per_s():
    """One card's NVLink bandwidth in one direction, bytes a second (None
    without the reading)."""
    if not NVLINK.is_file():
        return None
    d = json.loads(NVLINK.read_text())
    return d["links"] * d["gb_per_s_per_link"] * 1e9
