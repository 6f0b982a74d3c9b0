"""Roofline model of one step of the port on a named card: the NVIDIA H100
SXM.  Three terms a cell (arch x shape x mesh), from the tally of the
port's own program (`launch.op_stats`):

    compute    = FLOPs (a device)            / peak bf16 FLOP/s
    memory     = bytes (a device)            / HBM bytes/s
    collective = sum over the mesh's axes of
                 wire bytes on that axis      / that axis's bytes/s

`RooflineTerms` holds them; MODEL_FLOPS = 6·N_active·D (2·N·D forward)
gives the useful-compute ratio.  The port of `repro.launch.roofline`: the
terms and formulas are the reference's, the constants are the H100's, and
the collective term takes each axis at its own bandwidth, since an H100
cluster's "model" axis stays inside an NVLink node while "data" and "pod"
cross the network.  With one bandwidth for every axis it is the
reference's formula exactly.

`H100_SXM` holds NVIDIA's published figures for the H100 SXM5 80GB (the
"NVIDIA H100 Tensor Core GPU" datasheet: dense rates without sparsity,
at its 700 W limit; NVLink 4 at 900 GB/s a GPU in both directions; the
node's network one 400 Gb/s NDR InfiniBand port a GPU).  They are
datasheet figures, not measurements: a card set below 700 W runs slower,
and the dry run's terms are predictions for that card, not timings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..models import ModelConfig, ShapeConfig
from ..models.config import BLOCK_MOE


#: The mesh axes whose ranks share a node (`Hardware.intra_node_bw`); every
#: other axis crosses the network (`Hardware.inter_node_bw`).
NODE_AXES = ("model",)


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peaks and its links (`NODE_AXES`)."""

    name: str
    peak_flops_bf16: float        # FLOP/s, dense, on the tensor cores
    peak_flops_fp32: float        # FLOP/s, fp32 off the tensor cores
    hbm_bw: float                 # B/s
    hbm_bytes: float              # B of device memory
    intra_node_bw: float          # B/s a device, one direction
    inter_node_bw: float          # B/s a device, one direction

    def axis_bw(self, axis: Optional[str]) -> float:
        return self.intra_node_bw if axis in NODE_AXES else self.inter_node_bw

    def peak(self, dtype: str) -> float:
        """The FLOP/s of arithmetic in ``dtype`` ("bfloat16" or "float32")."""
        return self.peak_flops_fp32 if dtype == "float32" else self.peak_flops_bf16


#: NVIDIA H100 SXM5 80GB, datasheet figures (see the module's docstring).
H100_SXM = Hardware(
    name="NVIDIA H100 SXM5 80GB",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    intra_node_bw=450e9,          # NVLink 4: 900 GB/s a GPU, both directions
    inter_node_bw=50e9,           # 400 Gb/s NDR a GPU
)


def t_collective(wire: Iterable[Tuple[Optional[str], float]], hw: Hardware = H100_SXM,
                 scale: float = 1.0) -> float:
    """Seconds of ``wire``, (mesh axis, bytes a device) terms in the order
    they were counted: the bytes of the axes that share a bandwidth are
    summed in that order and sent at it, ``scale`` times."""
    by_bw: Dict[float, float] = {}
    for axis, nbytes in wire:
        bw = hw.axis_bw(axis)
        by_bw[bw] = by_bw.get(bw, 0.0) + nbytes
    return sum((scale * nbytes / bw for bw, nbytes in by_bw.items()), 0.0)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_by_axis: Dict[str, float]
    model_flops_total: float          # 6·N_active·D (train) / 2·N_active·D (fwd)
    peak_memory_bytes: Optional[float] = None
    hw: Hardware = H100_SXM

    @property
    def wire_bytes_per_device(self) -> float:
        return sum(self.wire_bytes_by_axis.values())

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak_flops_bf16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return t_collective(self.wire_bytes_by_axis.items(), self.hw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips × FLOPs a device): remat and repeated work."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu_roofline(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.t_step * self.chips * self.hw.peak_flops_bf16
        return self.model_flops_total / denom if denom else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hw": self.hw.name,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
            "t_step_s": self.t_step,
            "model_flops": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_roofline": self.mfu_roofline,
            "peak_memory_bytes": self.peak_memory_bytes,
        }


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = cfg.param_count()
    if cfg.n_experts:
        d = cfg.d_model
        mult = 3 if cfg.ffn_type == "swiglu" else 2
        expert_p = mult * d * cfg.d_ff
        n_moe = sum(1 for k in cfg.layer_pattern() if k == BLOCK_MOE)
        total -= n_moe * (cfg.n_experts - cfg.top_k) * expert_p
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D for a train step; 2·N·D per forward token otherwise (the
    standard dense-equivalent accounting; attention FLOPs excluded, which
    makes the reported useful-ratio conservative)."""
    n_active = active_params(cfg) - cfg.vocab_size * cfg.d_model * (
        2 if not cfg.tie_embeddings else 1)  # embeddings are lookups
    n_active = max(n_active, 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(int(n)) for n in shape)
