"""The metric battery (port of hoig_tpu/metrics): FID, LPIPS, SSIM and
MS-SSIM over the PNG trees that eval_torch.py writes, on the card unless
the caller passes device="cpu"."""

from hoig_torch.metrics.fid import calculate_fid_given_paths, calculate_frechet_distance
from hoig_torch.metrics.lpips import calculate_lpips_given_paths
from hoig_torch.metrics.ssim import calculate_ssim_given_paths, ms_ssim, ssim
