"""The benchmark of acousticswarms_speech_tpu_torch on one NVIDIA GPU
(see README.md)."""
