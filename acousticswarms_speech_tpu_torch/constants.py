"""Pipeline constants.

Host NumPy, copied from the JAX package's `constants.py` for the PyTorch port
(the port imports nothing of that package).

Rebuild of the constants plane of the reference implementation
(see reference sep/helpers/constants.py:1-47).  Values are part of the
measured-configuration contract (BASELINE.md) and must not drift.
"""
import os

import numpy as np

# Universal constants
SPEED_OF_SOUND = 343.0  # m/s
FS = 48000

# Project constants
MAX_SHIFTS = [2, 4]  # strict / relaxed hypercube half-widths (samples)
ROOM_DIM = 6
MAX_SPEAKER_RELATIVE_HEIGHT = 0.8
NEG_SAMPLE_INITIAL_CANDIDATES = 30

# Robot constants
CHANNELS_PER_MIC = 1
CODEC_FRAME_DURATION_S = 0.02

# SRP-PHAT parameters
INIT_WIDTH = 8          # initial TDoA hypercube width (samples)
BIN0 = 2
BIN1 = 200
FREQ_BINS = np.arange(BIN0, BIN1)   # STFT bins used by SRP-PHAT
N_FFT = 2048
SRP_THRESHOLD = 0.02

# Localization parameters
MIN_AREA = 400
MIN_WIDTH = 3
MIN_TOLERANCE = 4
# Power-ranked cap on coarse-stage survivors (reference constants.py:35).
# Round-4 retention root-cause (scripts/analyze_retention.py over the r3
# traces): at a loose SPOT_POWER_THRESHOLD1 this cap drops ~10% of GT
# speakers (33-54 passing patches, true patch ranked >30), half the 0.78
# fine-retention ceiling.  Env-tunable so dense scenes can raise it; cap
# truncation is recorded in the coarse power_trace record.
MAX_BIG_PATCH = int(os.environ.get("MAX_BIG_PATCH", "30"))
MIN_WIDTH_REQUIRED = 2

LOC_MODEL_THRESHOLD = 0.6
# The spot-power thresholds are the candidate-count knobs of the coarse and
# fine search stages; they must track the trained net's power dynamic range
# (an under-trained net has a flat range and passes everything).  Overridable
# via env so an eval sweep can re-tune them without a code edit.
USE_RELATIVE_SPOT_POWER = (
    os.environ.get("USE_RELATIVE_SPOT_POWER", "0") == "1")
# Defaults re-frozen from the round-4 post-fine-tune probe tuner
# (scripts/tune_thresholds.py over .results_r4_probe, 12 scenes, epoch-4
# fine-tuned net): coarse 0.004 retains 0.893 of GT speakers at 21.3
# candidates/scene (0.008 retained 0.839 at 18.9 — the converged net
# suppresses negatives, so the lower gate is nearly free); fine 0.008 is
# the retention plateau edge (0.821; 0.012 drops to 0.787).  Re-tune per
# released net.
SPOT_POWER_THRESHOLD1 = float(
    os.environ.get("SPOT_POWER_THRESHOLD1", "0.004"))
SPOT_POWER_THRESHOLD2 = float(
    os.environ.get("SPOT_POWER_THRESHOLD2", "0.008"))
SI_SNR_POWER_THRESHOLD = 4e-3

# Energy threshold to avoid choosing silence when generating hardware data
WINDOWED_RMS_POWER_THRESHOLD = 0.001

MAX_NUM = 25

# ---------------------------------------------------------------------------
# JAX-build additions (not in the reference): static-shape capacities used to
# keep every pipeline stage jit-compiled with fixed shapes.
# ---------------------------------------------------------------------------
SPOT_BATCH = 128          # spotforming batch (reference uses 128 too)
MAX_SMALL_PATCH = 512     # cap on concatenated fine-stage candidates
MAX_PEAKS = 256           # cap on SRP peaks fed to the greedy clusterer
