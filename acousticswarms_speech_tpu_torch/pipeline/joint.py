"""End-to-end joint localization + separation pipeline
(JAX: pipeline/joint.py).

Localize by separation (SRP pruning -> coarse spotform -> fine spotform ->
NMS), then separate by localization (one SepNet forward over the final
speakers' TDoAs).  The search geometry is set up once per microphone
configuration.

Each stage is a span of utils/spans.py named after its `stage_metrics()`
key: a `torch.profiler.record_function`, which `forward(mix,
profile_dir=...)` writes into a trace, timed on `time.perf_counter` into
`self.times[0..4]` in the reference's order (SRP, coarse, fine,
clustering, separation).  Inside the stages and the set-up, spans and
counters mark the layers: `search.subdivide` (host subdivision),
`device.wait` (the host's blocking reads of device results),
`array.geometry` and `array.steering_table` (set-up), and the counts
`search.subdivided_overlap`, `search.survivors_reused` and
`search.survivors` (the stage-1 overlap's reach).

Each forward (each chunk of `forward_streaming`) records them, with the
count of candidates swept (`search.candidates`) and, on an array's first
forward, the array's set-up spans.  A completed forward keeps its record as
`self.last_record` and appends it to the log of `spans.records()`; one
that raises publishes nothing, and its record, set-up included, is dropped.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..constants import FS
from ..device import resolve_device
from ..models.weights import load_release
from ..search.spotform import (SeparationInference, SpotformExecutor,
                               SweepLane, _BatchedSweep, to_numpy)
from ..utils import spans
from .mic_array import MicArray

# stage_metrics() keys of self.times[0..4], also the profiler spans' names
STAGES = ("time_srp_s", "time_coarse_spotform_s", "time_fine_spotform_s",
          "time_clustering_s", "time_separation_s")


class JointPipeline:
    def __init__(self, spot_model: torch.nn.Module | _BatchedSweep,
                 sep_model: torch.nn.Module | None, device=None,
                 use_bf16: bool = False,
                 sweep_crop_seconds: float | None = None, mesh=None):
        """`spot_model`: a SpotNet with its weights, or a sweep executor of
        search/spotform.py (e.g. DelayAndSumExecutor, which needs no
        weights) on the pipeline's device.  `sep_model`: a SepNet with its
        weights, or None for a pipeline that only localizes (its
        separation raises).  `device` defaults to cuda.  `use_bf16` runs
        both networks in bfloat16, as the JAX package's does.

        `mesh` (parallel/mesh.py): the coarse, fine and head sweeps shard
        their candidates over its `cand` ranks (search/spotform.py), and
        the pipeline runs on the mesh's device.  SRP, subdivision,
        clustering and separation run unsharded on every rank, as in the
        JAX package, so every rank must call `forward` with the same
        mixture, and every rank returns the same result.

        `sweep_crop_seconds` (or env SPOT_CROP_SECONDS): when > 0, the coarse
        and fine selection sweeps run on the loudest `sweep_crop_seconds`
        window of the mixture instead of all of it; the cluster heads then
        get one extra full-length strict sweep for NMS and output audio.
        Default 1.5 s, as in the JAX package; 0 sweeps the full mixture."""
        self.device = resolve_device(device, mesh)
        self.mesh = mesh
        # the pipeline's own view of the executor, which counts its spot
        # calls (lanes of pipeline/throughput.py share the executor)
        if isinstance(spot_model, _BatchedSweep):
            if spot_model.device != self.device:
                raise ValueError(f"the sweep executor runs on "
                                 f"{spot_model.device}, the pipeline on "
                                 f"{self.device}")
            executor = spot_model
        else:
            executor = SpotformExecutor(spot_model, use_bf16=use_bf16,
                                        device=self.device, mesh=mesh)
        self.spot_model = SweepLane(executor)
        self.sep_model = (None if sep_model is None else SeparationInference(
            sep_model, use_bf16=use_bf16, device=self.device))
        env_crop = os.environ.get("SPOT_CROP_SECONDS")
        self.sweep_crop_seconds = (
            float(env_crop) if env_crop is not None
            else (1.5 if sweep_crop_seconds is None else sweep_crop_seconds))
        self.times = [0.0] * 5
        self.previous_config: str | None = None
        self.mic_processor: MicArray | None = None
        self.last_record: spans.Record | None = None

    @classmethod
    def from_release(cls, spot_dir: str, sep_dir: str, device=None,
                     **kwargs) -> "JointPipeline":
        """Both networks from experiment directories' release weights
        (`<dir>/release/params_f16.msgpack`), in float32."""
        device = resolve_device(device, kwargs.get("mesh"))
        return cls(load_release(spot_dir, device), load_release(sep_dir, device),
                   device=device, **kwargs)

    @classmethod
    def from_experiments(cls, spot_exp_dir: str, sep_exp_dir: str,
                         device=None, **kwargs) -> "JointPipeline":
        """Both networks from experiment directories in 'best' mode: the
        best checkpoint by the sidecar's validation losses, else the
        release weights (training/experiment.py)."""
        from ..training.experiment import load_model_from_exp

        device = resolve_device(device, kwargs.get("mesh"))
        return cls(load_model_from_exp(spot_exp_dir, mode="best", device=device),
                   load_model_from_exp(sep_exp_dir, mode="best", device=device),
                   device=device, **kwargs)

    def setup(self, mic_positions: np.ndarray, speaker_range,
              cache_dir: str | None = None, grid_size: float = 0.05) -> None:
        """Initialize (or reuse) the search geometry for a mic configuration."""
        current_config = "~".join(
            f"{x:.05f}" for x in np.asarray(mic_positions).flatten()
        ) + "|" + "~".join(f"{x:.05f}" for x in speaker_range)
        if current_config == self.previous_config:
            return
        self.mic_processor = MicArray(mic_positions, spk_range=speaker_range,
                                      cache_dir=cache_dir, grid_size=grid_size,
                                      device=self.device)
        self.previous_config = current_config

    def forward(self, mix_data, profile_dir: str | None = None):
        """mix_data: (M, T).  Returns (patches, audio_loc, audio, srp_drop,
        stage1_drop, spot_times).

        `profile_dir`: trace the whole forward with `torch.profiler` (host
        activity, and the card's kernels when the pipeline runs on one)
        and write it there as a Chrome trace (`*.pt.trace.json`), with one
        span per stage named after its `stage_metrics()` key."""
        if profile_dir is None:
            return self._forward(mix_data)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    profile_dir)):
            return self._forward(mix_data)

    __call__ = forward

    def _crop_slice(self, mix_np: np.ndarray):
        """(start, length) of the loudest `sweep_crop_seconds` window of the
        reference channel, or None when cropping is off or the mixture is
        already shorter."""
        crop_s = self.sweep_crop_seconds
        if crop_s <= 0:
            return None
        T = mix_np.shape[1]
        # keep at least the 12000-sample power window + shift margin
        L = max(int(crop_s * FS), 16384)
        if L >= T:
            return None
        x2 = np.cumsum(mix_np[0].astype(np.float64) ** 2)
        sums = x2[L - 1 :] - np.concatenate([[0.0], x2[: T - L]])
        return int(np.argmax(sums)), L

    @torch.no_grad()
    def _forward(self, mix_data):
        record = spans.Record()
        processor = self.mic_processor
        if processor is not None and processor.setup_record is not None:
            record.spans += processor.setup_record.spans
            processor.setup_record = None
        with spans.recording(record):
            mix_np = to_numpy(mix_data)
            crop = self._crop_slice(mix_np)
            # upload once; every stage reads the device copy
            mix = torch.as_tensor(mix_np, dtype=torch.float32,
                                  device=self.device)
            mix_sweep = (mix[:, crop[0] : crop[0] + crop[1]].contiguous()
                         if crop is not None else None)
            self.times = [0.0] * 5
            patches, audio_loc, srp_drop, stage1_drop, spot_times = \
                self.localize_by_separation(mix, mix_sweep=mix_sweep)
            with self._stage(4):
                audio = self.separate_by_localization(mix, patches)
        self.last_record = record
        spans.publish(record)
        return patches, audio_loc, audio, srp_drop, stage1_drop, spot_times

    @contextlib.contextmanager
    def _stage(self, i: int):
        """Times stage `i` into self.times[i]: the duration of its span."""
        with spans.span(STAGES[i]) as s:
            yield
        self.times[i] = s.seconds

    def stage_metrics(self) -> dict:
        return {**dict(zip(STAGES, self.times)),
                "spotform_calls": self.spot_model.calls}

    def localize_by_separation(self, mix_data, mix_sweep=None):
        """`mix_sweep`: optional cropped copy of `mix_data` for the selection
        sweeps; when given, cluster heads are re-spotformed on the full
        mixture inside stage 2."""
        assert self.previous_config is not None, \
            "Mic positions and speaker range not provided; call .setup() first"

        with self._stage(0):
            patch_list, _ = self.mic_processor.apply_srp_phat(mix_data)
        if len(patch_list) <= 0:
            return [], [], 0, 0, 0

        sweep_mix = mix_sweep if mix_sweep is not None else mix_data
        with self._stage(1):
            # Queue the coarse sweep, then subdivide candidates on the host
            # while the device works, until the sweep is done: the
            # survivors not reached yet are subdivided in stage 2.  The
            # outputs do not depend on how many were reached (subdivision
            # is a pure host function), so ranks of a mesh may reach
            # different numbers.
            processor = self.mic_processor
            coarse = self.spot_model.sweep(sweep_mix, patch_list, strict=0)
            subdivided = {}
            for p in patch_list:
                if coarse.is_ready():
                    break
                subdivided[id(p)] = processor.subdivide_patch(p)
            spans.count("search.subdivided_overlap", len(subdivided))
            patch_list = processor.spotform_big_patch(
                sweep_mix, patch_list, self.spot_model, sweep=coarse)
        if len(patch_list) <= 0:
            return [], [], 0, 0, 0

        with self._stage(2):
            output_pair = processor.spotform_small_patch_parallel(
                sweep_mix, patch_list, self.spot_model, subdivided=subdivided,
                full_mix=mix_data if mix_sweep is not None else None)
        if len(output_pair) <= 0:
            return [], [], 0, 0, 0

        with self._stage(3):
            audio_final, patch_final, spot_times, _ = \
                processor.clustering_new(output_pair)
        if len(patch_final) <= 0:
            return [], [], 0, 0, 0
        return patch_final, np.array(audio_final), 0, 0, spot_times

    def separate_by_localization(self, mix_data, target_patches):
        if len(target_patches) == 0:
            return None
        return self._separation().infer(mix_data,
                                        [p[0] for p in target_patches])

    def separate_by_localization_by_sample(self, mix_data, sample_lists):
        """SepNet at the given TDoA offset vectors ((M-1,) each) instead of
        the heads' patches."""
        if len(sample_lists) == 0:
            return None
        return self._separation().infer_sample(mix_data, sample_lists)

    def _separation(self) -> SeparationInference:
        if self.sep_model is None:
            raise ValueError("this pipeline has no separation network")
        return self.sep_model

    def forward_streaming(self, mix_data: np.ndarray, chunk_samples: int,
                          merge_dist: float = 0.45, overlap: int = 0,
                          max_offset_jump: int = 6):
        """Long-form inference: process fixed-size chunks reusing the search
        setup (the chunked-streaming mode the reference leaves as future work,
        reference README.md:144).

        - Chunks advance by `chunk_samples - overlap`; the final chunk is
          aligned to the end of the stream so the tail is never dropped.
        - Tracks merge across chunks when EITHER the 2D position moves less
          than `merge_dist` OR every TDoA offset moves by at most
          `max_offset_jump` samples (offset continuity is robust where two
          speakers sit at similar ranges).
        - Each track's chunk audio is assembled into one full-length
          waveform with raised-cosine crossfades over the overlap regions
          (fade-in/out where the speaker is absent in a neighbouring chunk).

        Returns (tracks, per_chunk): tracks are dicts with "position",
        "offsets", "chunks" {chunk_idx: audio} and the assembled "audio"
        (T,); per_chunk holds each chunk's raw pipeline outputs."""
        M, T = mix_data.shape
        hop = chunk_samples - overlap
        assert hop > 0, "overlap must be smaller than chunk_samples"
        starts = list(range(0, max(T - chunk_samples, 0) + 1, hop))
        if starts[-1] + chunk_samples < T:
            starts.append(T - chunk_samples)  # tail-aligned final chunk

        tracks: list[dict] = []
        per_chunk = []
        for ci, start in enumerate(starts):
            chunk = mix_data[:, start : start + chunk_samples]
            if chunk.shape[1] < chunk_samples:  # stream shorter than a chunk
                chunk = np.pad(chunk,
                               ((0, 0), (0, chunk_samples - chunk.shape[1])))
            patches, audio_loc, audio, *_rest = self._forward(chunk)
            per_chunk.append((patches, audio_loc, audio))
            if len(patches) == 0:
                continue
            for k, pf in enumerate(patches):
                pos = np.asarray(pf[0].center_pos())
                off = np.asarray(pf[4]["localization_offset"])
                wav = audio[k] if audio is not None and k < len(audio) \
                    else audio_loc[k]
                for tr in tracks:
                    d2 = np.linalg.norm(np.asarray(tr["position"][:2])
                                        - pos[:2])
                    prev = np.asarray(tr["offsets"])
                    d_off = (np.max(np.abs(prev - off))
                             if prev.shape == off.shape else np.inf)
                    if (d2 < merge_dist or d_off <= max_offset_jump) \
                            and ci not in tr["chunks"]:
                        tr["chunks"][ci] = wav
                        tr["position"] = pos  # follow the latest estimate
                        tr["offsets"] = off
                        break
                else:
                    tracks.append({
                        "position": pos,
                        "offsets": off,
                        "chunks": {ci: wav},
                    })

        for tr in tracks:
            tr["audio"] = self._assemble_track(tr["chunks"], starts,
                                               chunk_samples, overlap, T)
        return tracks, per_chunk

    @staticmethod
    def _assemble_track(chunks: dict, starts: list, chunk_samples: int,
                        overlap: int, T: int) -> np.ndarray:
        """Overlap-add chunk waveforms into one stream with raised-cosine
        crossfades: complementary ramps sum to 1 where neighbouring chunks
        both contain the speaker, and fade smoothly to silence where only
        one does."""
        out = np.zeros(T, dtype=np.float32)
        wsum = np.zeros(T, dtype=np.float32)
        last_ci = len(starts) - 1
        for ci in sorted(chunks):
            start = starts[ci]
            n = min(chunk_samples, T - start)
            w = np.ones(n, dtype=np.float32)
            ramp = min(overlap, n // 2)
            if ramp > 1:
                r = 0.5 * (1.0 - np.cos(np.linspace(0.0, np.pi, ramp)))
                if ci > 0:
                    w[:ramp] *= r
                if ci < last_ci:
                    w[-ramp:] *= r[::-1]
            wav = np.asarray(chunks[ci], dtype=np.float32)[:n]
            out[start : start + n] += wav * w[: len(wav)]
            wsum[start : start + n] += w
        # tail-aligned final chunks overlap arbitrarily much with their
        # predecessor; average where total weight exceeds 1
        return out / np.maximum(wsum, 1.0)
