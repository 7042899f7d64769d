"""Command-line tools of the port (JAX: scripts/ and examples/), each run
with `python -m acousticswarms_speech_tpu_torch.scripts.<name>`:
precompute_geometry, export_release, export_if_better,
seed_checkpoint_from_release and quickstart; the re-tune loop
retune_release and the trace tools it runs (replay_nms, tune_thresholds,
analyze_probe, analyze_retention); probe_sep_batch and run_eval_suite;
bench; roll_ab, which times csrc/roll.cu against other versions of it."""
