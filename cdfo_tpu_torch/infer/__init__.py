from .engine import BatchedStreamingEngine
from .pipeline import (SequenceData, crop_sr_output, pad_lr_frame,
                       synthetic_sequence)

__all__ = ["BatchedStreamingEngine", "SequenceData", "crop_sr_output",
           "pad_lr_frame", "synthetic_sequence"]
