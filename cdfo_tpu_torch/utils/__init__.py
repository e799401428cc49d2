"""Profiling, FLOP and parameter counts (``utils/profiling.py``)."""
from .profiling import Timer, count_params, estimate_flops, trace_profile

__all__ = ["Timer", "count_params", "estimate_flops", "trace_profile"]
