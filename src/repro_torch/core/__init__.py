"""FCP core: block-wise context-parallel scheduling and execution."""

from ..masks import (CAUSAL, FULL, MaskSpec, chunked, coerce_mask,
                     parse_mask, sliding_window)
from .blocks import (Block, BlockedBatch, Segment, kv_dependencies,
                     shard_stream, zigzag_order)
from .cost_model import (GPU_X, GPU_Y, HARDWARE, TPU_V5E, HardwareProfile,
                         SimFlags, kernel_efficiency,
                         simulate_attention_module, total_attention_flops)
from .distributor import AssignmentResult, assign_blocks
from .planner import (build_comm_edges, build_reshuffle_edges,
                      coalesce_matchings, decompose_matchings,
                      group_coalesced_round, verify_matchings)
from .schedule import (CommGroup, CommRound, PlanArrays, Schedule,
                       StaticSpec, make_schedule)

__all__ = [
    "Block", "BlockedBatch", "Segment", "kv_dependencies", "shard_stream",
    "zigzag_order", "GPU_X", "GPU_Y", "HARDWARE", "TPU_V5E",
    "HardwareProfile", "SimFlags", "kernel_efficiency",
    "simulate_attention_module", "total_attention_flops",
    "AssignmentResult", "assign_blocks", "build_comm_edges",
    "build_reshuffle_edges", "coalesce_matchings", "decompose_matchings",
    "group_coalesced_round", "verify_matchings", "CommGroup", "CommRound",
    "PlanArrays", "Schedule", "StaticSpec", "make_schedule",
    "CAUSAL", "FULL", "MaskSpec", "chunked", "coerce_mask", "parse_mask",
    "sliding_window",
]
