from .losses import (
    charbonnier_etc_loss,
    charbonnier_loss,
    charbonnier_loss_masked,
    mse_loss,
    sobel_loss,
    total_variation,
)

__all__ = [
    "charbonnier_loss", "charbonnier_loss_masked", "charbonnier_etc_loss",
    "mse_loss", "sobel_loss", "total_variation",
]
