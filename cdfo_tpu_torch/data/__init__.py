from .dataset import CVCPDataset, TrainBatcher
from .io import (load_eval_sequence, make_synthetic_cvcp_tree,
                 pad_270_to_272, read_gray, write_gray)

__all__ = ["CVCPDataset", "TrainBatcher", "load_eval_sequence",
           "make_synthetic_cvcp_tree", "pad_270_to_272", "read_gray",
           "write_gray"]
