"""Utilities: config system, profiling/metrics, BMP helpers.

The reference has exactly one runtime parameter (the decoder method enum,
grc/ldpc_ece535a_ldpc_decoder_cb.xml) and hardcodes everything else —
iterations=5, sync threshold M/8, max 10 bad frames
(lib/ldpc_decoder_cb_impl.cc:39-40,141-142,171) — and ships no tracing,
metrics, or profiling at all (SURVEY.md §5). This package promotes those
constants to a config layer and adds the observability a device build needs.
"""

from .bmp import make_bmp, parse_bmp_header
from .config import ChannelConfig, PipelineConfig, ReceiverConfig, SimConfig
from .profiling import (Timer, ThroughputMeter,
                        enable_persistent_compile_cache, trace)

__all__ = [
    "ChannelConfig",
    "PipelineConfig",
    "ReceiverConfig",
    "SimConfig",
    "ThroughputMeter",
    "Timer",
    "enable_persistent_compile_cache",
    "make_bmp",
    "parse_bmp_header",
    "trace",
]
