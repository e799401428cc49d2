"""Image-quality metrics: numpy copies of ``cdfo_tpu.metrics``'
full-reference and no-reference metrics, their fits and the MATLAB helpers,
and LPIPS with its head trainer in PyTorch."""
from .brisque import calculate_brisque
from .fit import (fit_ilniqe_template, fit_niqe_params, fit_nrqm_forest,
                  save_ilniqe_template, save_niqe_params, save_nrqm_model)
from .ilniqe import calculate_ilniqe
from .lpips import LPIPS, load_torch_weights
from .lpips_train import (Dist2LogitLayer, LPIPSHeadTrainer,
                          bce_ranking_loss, score_2afc, score_jnd)
from .niqe import calculate_niqe
from .nrqm import calculate_nrqm, calculate_pi
from .psnr_ssim import (
    bgr2ycbcr,
    cal_psnr_ssim,
    cal_psnr_ssim_tof,
    cal_psnr_ssim_tof_cvcp,
    cal_psnr_ssim_tof_reds,
    cal_psnr_ssim_tof_vid4,
    calculate_psnr,
    calculate_ssim,
    calculate_tof,
    rgb2ycbcr,
    to_y_channel,
    ycbcr2bgr,
    ycbcr2rgb,
)
from .video_quality import cal_sequence_noref, default_nrqm_model

__all__ = [
    "calculate_psnr", "calculate_ssim", "calculate_tof", "cal_psnr_ssim",
    "cal_psnr_ssim_tof", "cal_psnr_ssim_tof_cvcp", "cal_psnr_ssim_tof_reds",
    "cal_psnr_ssim_tof_vid4", "rgb2ycbcr", "bgr2ycbcr", "ycbcr2rgb",
    "ycbcr2bgr", "to_y_channel", "calculate_niqe", "calculate_brisque",
    "calculate_ilniqe", "calculate_nrqm", "calculate_pi",
    "cal_sequence_noref", "default_nrqm_model", "fit_niqe_params",
    "save_niqe_params", "fit_ilniqe_template", "save_ilniqe_template",
    "fit_nrqm_forest", "save_nrqm_model", "LPIPS", "load_torch_weights",
    "Dist2LogitLayer", "LPIPSHeadTrainer", "bce_ranking_loss", "score_2afc",
    "score_jnd",
]
