"""Evaluation of the PyTorch port: PSNR, RotErr/TransErr (metrics.py) and the
Fréchet distances FID/FVD (fid.py)."""

from synfmc_tpu_torch.evaluation.metrics import (
    camera_errors_from_txt,
    psnr,
    rot_err_deg,
    trans_err,
)

__all__ = ["psnr", "rot_err_deg", "trans_err", "camera_errors_from_txt"]
