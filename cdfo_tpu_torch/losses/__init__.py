from .losses import (
    charbonnier_etc_loss,
    charbonnier_loss,
    charbonnier_loss_masked,
    mse_loss,
    sobel_loss,
    total_variation,
)
from .wavelet import (charbonnier_fcl_loss, haar_dwt,
                      multiwave_contrastive_loss, wave_decompose)

__all__ = [
    "charbonnier_loss", "charbonnier_loss_masked", "charbonnier_etc_loss",
    "mse_loss", "sobel_loss", "total_variation", "haar_dwt",
    "wave_decompose", "multiwave_contrastive_loss", "charbonnier_fcl_loss",
]
