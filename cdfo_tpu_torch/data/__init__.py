from .dataset import CVCPDataset, TrainBatcher
from .io import make_synthetic_cvcp_tree, pad_270_to_272, read_gray, write_gray

__all__ = ["CVCPDataset", "TrainBatcher", "make_synthetic_cvcp_tree",
           "pad_270_to_272", "read_gray", "write_gray"]
