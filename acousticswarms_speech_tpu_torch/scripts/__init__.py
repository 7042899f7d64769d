"""Command-line tools of the port (JAX: scripts/ and examples/), each run
with `python -m acousticswarms_speech_tpu_torch.scripts.<name>`:
precompute_geometry, export_release, export_if_better,
seed_checkpoint_from_release and quickstart."""
