from .engine import BatchedStreamingEngine
from .pipeline import (SequenceData, StreamingInferencer, crop_sr_output,
                       pad_lr_frame, synthetic_sequence)

__all__ = ["BatchedStreamingEngine", "SequenceData", "StreamingInferencer",
           "crop_sr_output", "pad_lr_frame", "synthetic_sequence"]
