from .audio import read_audio_file, read_wav, write_audio_file, write_wav
from .metrics import max_avg_power, si_sdr, split_wav, split_wise_sisdr
from .misc import (
    Timer,
    list_top_level_directories,
    read_json,
    read_metadata,
    seed_all,
    write_json,
)
from .pink_noise import powerlaw_psd_gaussian
from .denoise import denoise
from .shift import (
    criterion,
    get_shift_vector,
    phase_offset,
    sample_offsets_for,
    shift_crop_given_samples,
    shift_mixture_given_samples,
    to_categorical,
)
