from .fused_attention import column_self_attention, token_self_attention
from .resize import interpolate_bilinear, pixel_shuffle
from .warp import flow_warp, flow_warp_ring

__all__ = ["column_self_attention", "token_self_attention",
           "interpolate_bilinear", "pixel_shuffle", "flow_warp",
           "flow_warp_ring"]
