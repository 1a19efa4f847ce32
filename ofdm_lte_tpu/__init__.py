"""ofdm_lte_tpu — an LTE physical-layer simulation framework in JAX.

Built from scratch in JAX/XLA (complex-as-real-pairs, DFT-as-matmul, batched
Monte-Carlo over device meshes) and run on NVIDIA GPUs. Provides the
capabilities of
the reference NumPy simulator (Darioxavierl/OFDM-LTE): OFDM/SC-FDM modems with
LTE resource grids and CRS pilots, AWGN / ITU-R M.1225 Rayleigh channels,
CRS estimation + ZF/MRC/Alamouti/MIMO detection, TM4/TM6 precoding with CSI
feedback, and the TS 36.212 channel-coding chain.
"""

from .config import (LTEConfig, LTE_PROFILES, CP_VALUES_US, MODULATION_SCHEMES,
                     ITU_CHANNEL_MODELS, doppler_hz)
from .cplx import C
from . import cplx, grid

__version__ = "0.1.0"

__all__ = [
    "LTEConfig", "LTE_PROFILES", "CP_VALUES_US", "MODULATION_SCHEMES",
    "ITU_CHANNEL_MODELS", "doppler_hz", "C", "cplx", "grid",
]
