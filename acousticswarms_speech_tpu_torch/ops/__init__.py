from .power import candidate_powers, windowed_rms_max
from .shift import (
    roll_channels_batch,
    roll_channels_batch_plain,
    roll_zero_fill_batch,
)
from .similarity import sisdr_matrix
from .srp import SrpMapComputer, build_steering_table, srp_phat_map, srp_window_size
from .stft import stft_bins, stft_windowed_bins
