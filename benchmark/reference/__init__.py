"""The benchmark's plain reference: a frozen copy of the semantics of the
port's main path (acousticswarms_speech_tpu_torch at commit 300ffdc) in plain
PyTorch and NumPy, float32 only.  SpotNet and SepNet are plain `torch`
modules, the roll is `torch.gather` in place of the CUDA kernel, and the
search (SRP map and pruning, subdivision, clustering) is the same host NumPy
over the same device SRP map.  It imports nothing of the port, and takes
nothing the port made: it reads release weights with its own msgpack reader,
and builds the geometry and the steering table itself."""
