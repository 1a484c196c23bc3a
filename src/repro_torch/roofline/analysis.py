"""Roofline analysis of the traced dry-run step (no real hardware).

Counterpart of ``repro.roofline.analysis``.  Three terms per (arch × shape ×
mesh), in seconds:

    compute    = FLOPs per device / peak_FLOP/s
    memory     = bytes accessed per device / HBM_bw
    collective = collective bytes per device / link_bw

FLOPs, bytes and collective bytes are one rank's own step, run on ``meta``
DTensors (``roofline.trace``: ``Compiled.cost_analysis()`` and
``Compiled.collectives()``; on one device the global trace), where the
reference reads XLA's per-device program; ``extrapolate`` takes two
depths' collectives to the full depth as the reference's ``run_cell``
does.

Hardware constants: NVIDIA H100 SXM 80 GB (NVIDIA's H100 data sheet) —
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, 80 GB.  The
link: a production mesh (16 × 16 = 256 GPUs, or 2 × 16 × 16) spans
32-64 eight-GPU nodes, so its axes cross the network between nodes, where a
DGX H100 gives each GPU one 400 Gb/s NDR InfiniBand port (ConnectX-7; the
DGX H100 user guide): 50 GB/s a direction.  NVLink 4 within a node (450
GB/s a direction) would apply only to a mesh that stays inside one node,
which no mesh here does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

PEAK_FLOPS = 989e12         # bf16 per GPU, dense
HBM_BW = 3.35e12            # bytes/s per GPU
HBM_BYTES = 80e9            # bytes of HBM per GPU
LINK_BW = 50e9              # bytes/s per GPU (one direction) between nodes


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: float, times: int = 1) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + times
        self.bytes_by_kind[kind] = (self.bytes_by_kind.get(kind, 0)
                                    + nbytes * times)


def extrapolate(c1: CollectiveStats, c2: CollectiveStats, l1: int, l2: int,
                depth: int) -> CollectiveStats:
    """The collectives at ``depth`` layers from the counts at ``l1`` and
    ``l2`` (the reference's ``run_cell``: linear in depth, counts cut to
    ints); the total's clamp (monotone in depth) is the caller's, as
    there."""
    scale = (depth - l1) / max(1, l2 - l1)
    kinds = set(c1.counts) | set(c2.counts)
    counts = {k: int(c1.counts.get(k, 0) + (c2.counts.get(k, 0)
                                            - c1.counts.get(k, 0)) * scale)
              for k in kinds}
    nbytes = {k: c1.bytes_by_kind.get(k, 0) + (
        c2.bytes_by_kind.get(k, 0) - c1.bytes_by_kind.get(k, 0)) * scale
              for k in kinds}
    return CollectiveStats(counts, nbytes)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float            # traced FLOPs per device (the name kept
                                 # from the reference's HLO count)
    hlo_gbytes: float
    collective_gbytes: float     # per-chip bytes over the links
    compute_s: float
    memory_s: float
    collective_s: float
    model_gflops: float          # 6·N·D (or 6·N_active·D)
    collectives: Dict[str, int] = field(default_factory=dict)
    collective_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    bytes_per_device: Optional[float] = None
    fits_hbm: Optional[bool] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        if self.hlo_gflops <= 0:
            return 0.0
        return self.model_gflops / self.hlo_gflops

    @property
    def step_time_s(self) -> float:
        """Roofline step estimate: overlap-free upper bound is the max term;
        we report the max (ideal overlap) — the bottleneck term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max-term: 1.0 = perfectly compute-bound."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_gflops": round(self.hlo_gflops, 1),
            "hlo_gbytes": round(self.hlo_gbytes, 2),
            "coll_gbytes": round(self.collective_gbytes, 3),
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "dominant": self.dominant,
            "model_gflops": round(self.model_gflops, 1),
            "useful_ratio": round(self.useful_flops_ratio, 3),
            "roofline_fraction": round(self.roofline_fraction, 3),
            "bytes_per_device_gb": (round(self.bytes_per_device / 2**30, 2)
                                    if self.bytes_per_device else None),
            "fits_hbm_80g": self.fits_hbm,
            "collectives": self.collectives,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for a train step, 2·N·D for inference (per the
    standard decoder accounting), using active params for MoE.  D = tokens
    processed by the step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def analyze(arch: str, shape, mesh_name: str, chips: int, cost: dict,
            collectives: Optional[CollectiveStats], cfg,
            memory_stats: Optional[dict] = None) -> Roofline:
    """The reference's ``analyze`` with ``collectives`` (from
    ``Compiled.collectives()``, or ``None`` for none) in place of its HLO
    text, and the fit test at ``HBM_BYTES``."""
    flops = float(cost.get("flops", 0.0))
    # bytes accessed: sum the "bytes accessed" keys
    nbytes = float(cost.get("bytes accessed", 0.0))
    if nbytes == 0.0:
        nbytes = sum(float(v) for k, v in cost.items()
                     if k.startswith("bytes accessed"))
    coll = collectives or CollectiveStats()
    mf = model_flops(cfg, shape)

    # the cost is per device (the trace's global count over the chips)
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = coll.total_bytes / LINK_BW

    bytes_per_device = None
    fits = None
    if memory_stats:
        bytes_per_device = memory_stats.get("bytes_per_device")
        if bytes_per_device:
            fits = bytes_per_device <= HBM_BYTES

    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=nbytes / 1e9,
        collective_gbytes=coll.total_bytes / 1e9,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_gflops=mf / 1e9 / chips,
        collectives=coll.counts,
        collective_bytes_by_kind={k: v / 1e9 for k, v in
                                  coll.bytes_by_kind.items()},
        bytes_per_device=bytes_per_device, fits_hbm=fits)
