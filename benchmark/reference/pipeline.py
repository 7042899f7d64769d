# Frozen copy of acousticswarms_speech_tpu_torch/pipeline/joint.py
# (JointPipeline.setup, _crop_slice, _forward, localize_by_separation,
# separate_by_localization) at commit 300ffdc, part of the benchmark's plain
# reference: it imports nothing of the port.
"""The joint localize-then-separate forward, plain PyTorch and NumPy.

`ReferencePipeline.forward` returns what the port's `JointPipeline.forward`
returns, and besides the stage-0 results the benchmark compares: the SRP
map and the pruned patches.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import FS
from .mic_array import MicArray
from .sweep import SeparationInference, SpotformExecutor, to_numpy


class ReferencePipeline:
    def __init__(self, spot_model: torch.nn.Module, sep_model: torch.nn.Module,
                 device="cuda", sweep_crop_seconds: float = 1.5):
        """`sweep_crop_seconds`: the selection sweeps run on the loudest
        window of this length (the port's default 1.5 s)."""
        self.device = torch.device(device)
        self.sweep_crop_seconds = sweep_crop_seconds
        self.spot_model = SpotformExecutor(spot_model, device=self.device)
        self.sep_model = SeparationInference(sep_model, device=self.device)
        self.mic_processor: MicArray | None = None

    def setup(self, mic_positions: np.ndarray, speaker_range,
              grid_size: float = 0.05) -> None:
        """The search geometry and steering table of one array, built anew."""
        self.mic_processor = MicArray(mic_positions, spk_range=speaker_range,
                                      grid_size=grid_size, device=self.device)

    def _crop_slice(self, mix_np: np.ndarray):
        """(start, length) of the loudest `sweep_crop_seconds` window of the
        reference channel, or None when the mixture is shorter."""
        T = mix_np.shape[1]
        L = max(int(self.sweep_crop_seconds * FS), 16384)
        if L >= T:
            return None
        x2 = np.cumsum(mix_np[0].astype(np.float64) ** 2)
        sums = x2[L - 1 :] - np.concatenate([[0.0], x2[: T - L]])
        return int(np.argmax(sums)), L

    @torch.no_grad()
    def forward(self, mix_data) -> dict:
        """mix_data (M, T) -> dict with `srp_map` (G,), `patches0` (the
        stage-0 patches), `heads` (the port's patch tuples), `audio_loc`
        (heads, T), `audio` (heads, T) and `spot_calls`."""
        mix_np = to_numpy(mix_data)
        crop = self._crop_slice(mix_np)
        mix = torch.as_tensor(mix_np, dtype=torch.float32, device=self.device)
        mix_sweep = (mix[:, crop[0] : crop[0] + crop[1]].contiguous()
                     if crop is not None else None)
        self.spot_model.calls = 0
        result = {"srp_map": None, "patches0": [], "heads": [],
                  "audio_loc": np.zeros((0, mix_np.shape[1]), np.float32),
                  "audio": None, "spot_calls": 0}
        processor = self.mic_processor
        patch_list, _ = processor.apply_srp_phat(mix)
        result["srp_map"] = processor.srp.srp_map
        # copies: the search narrows the patches it subdivides in place
        result["patches0"] = [(p.sample_offset.copy(), p.width_list.copy())
                              for p in patch_list]
        if patch_list:
            sweep_mix = mix_sweep if mix_sweep is not None else mix
            patch_list = processor.spotform_big_patch(sweep_mix, patch_list,
                                                      self.spot_model)
            if patch_list:
                output_pair = processor.spotform_small_patch_parallel(
                    sweep_mix, patch_list, self.spot_model,
                    full_mix=mix if mix_sweep is not None else None)
                if output_pair:
                    audio_final, patch_final, _, _ = \
                        processor.clustering_new(output_pair)
                    if patch_final:
                        result["heads"] = patch_final
                        result["audio_loc"] = np.array(audio_final)
                        result["audio"] = self.sep_model.infer(
                            mix, [p[0] for p in patch_final])
        result["spot_calls"] = self.spot_model.calls
        return result
