"""PyTorch/CUDA port of the acoustic-swarm speech pipeline.

A second package beside the JAX reference `acousticswarms_speech_tpu`: the
same module names, with PyTorch modules and plain functions on tensors.  It
imports `torch` and never `jax`, `flax`, `msgpack` or the JAX package.

    from acousticswarms_speech_tpu_torch import JointPipeline
    pipe = JointPipeline.from_release(spot_dir, sep_dir, device="cuda")
    pipe.setup(mic_positions, speaker_range)
    patches, audio_loc, audio, *_ = pipe.forward(mix)

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
card they raise instead of falling back.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy so that importing the package (or one host module) stays light.
    if name == "JointPipeline":
        from .pipeline.joint import JointPipeline

        return JointPipeline
    if name == "MicArray":
        from .pipeline.mic_array import MicArray

        return MicArray
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
