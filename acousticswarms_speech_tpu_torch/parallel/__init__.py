"""Multi-process parallelism (JAX: parallel/): the mesh and its launcher,
the sharded SRP maps and the data-parallel train step (mesh.py), the rank
programs that `launch` runs (ranks.py) and the dry run (dryrun.py)."""
