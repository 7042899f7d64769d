# Frozen copy of acousticswarms_speech_tpu_torch/constants.py at commit 300ffdc,
# part of the benchmark's plain reference: it imports nothing of the port.
"""Pipeline constants, with the values the port takes when no environment
variable overrides them (the benchmark runs the port without overrides)."""
import numpy as np

SPEED_OF_SOUND = 343.0  # m/s
FS = 48000

# SRP-PHAT parameters
INIT_WIDTH = 8          # initial TDoA hypercube width (samples)
FREQ_BINS = np.arange(2, 200)   # STFT bins used by SRP-PHAT
N_FFT = 2048

# Localization parameters
MIN_AREA = 400
MIN_WIDTH = 3
MAX_BIG_PATCH = 30      # power-ranked cap on coarse-stage survivors
MIN_WIDTH_REQUIRED = 2
USE_RELATIVE_SPOT_POWER = False
SPOT_POWER_THRESHOLD1 = 0.004
SPOT_POWER_THRESHOLD2 = 0.008
