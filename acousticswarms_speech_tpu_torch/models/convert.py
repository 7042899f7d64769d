"""Reference torch checkpoints into the port (JAX package: models/convert.py).

Maps the reference's state-dict names (the SpeakerLocalization and
SpeakerSeparation network module structure) onto the JAX package's
parameter tree, whose names and layouts the port's modules follow; the
tree then goes through the port's loader (`models/weights.py:
from_jax_params`).  All modules use torch layouts, so the conversion is
pure renaming with no transposes.

Known-mapped structure:
- preproc / reference_bypass / mask_encoder / output_decoder convs
- encoder.module_list.{i}.(res.seq.{j}.(conv|norm) | conv1 | norm1 | embed1)
- decoder.module_list.{i}.(upsample.conv | norm1 | embed1 | res.seq.{j}.*)
- loc bottleneck.transf.layers.{i}.* (torch TransformerEncoderLayer)
- sep bottleneck.module_list.{l}.inter.layers.0.* (torch layer)
- sep bottleneck.module_list.{l}.intra.* (speechbrain ConformerEncoder):
  full table incl. the encoder-level final norm.

CLI:  python -m acousticswarms_speech_tpu_torch.models.convert \
          <ckpt.pt> <model_name> <out.msgpack>
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from .weights import from_jax_params


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


_COMMON_RULES: list[tuple[str, str]] = [
    (r"^preproc\.(weight|bias)$", r"preproc/\1"),
    (r"^reference_bypass\.(weight|bias)$", r"reference_bypass/\1"),
    (r"^mask_encoder\.(weight|bias)$", r"mask_encoder/\1"),
    (r"^output_decoder\.(weight|bias)$", r"output_decoder/\1"),
    (r"^encoder\.module_list\.(\d+)\.res\.seq\.(\d+)\.(conv|norm)\.(weight|bias)$",
     r"encoder_\1/res/seq_\2/\3/\4"),
    (r"^encoder\.module_list\.(\d+)\.(conv1|norm1|embed1)\.(weight|bias)$",
     r"encoder_\1/\2/\3"),
    (r"^decoder\.module_list\.(\d+)\.upsample\.conv\.(weight|bias)$",
     r"decoder_\1/upsample_conv/\2"),
    (r"^decoder\.module_list\.(\d+)\.(norm1|embed1)\.(weight|bias)$",
     r"decoder_\1/\2/\3"),
    (r"^decoder\.module_list\.(\d+)\.res\.seq\.(\d+)\.(conv|norm)\.(weight|bias)$",
     r"decoder_\1/res/seq_\2/\3/\4"),
]

# NOTE: these fragments are concatenated after a prefix containing ONE
# capture group (the layer index), so internal group references start at \2.
_TORCH_TRANSFORMER_RULES: list[tuple[str, str]] = [
    (r"self_attn\.in_proj_weight$", r"self_attn/in_proj_weight"),
    (r"self_attn\.in_proj_bias$", r"self_attn/in_proj_bias"),
    (r"self_attn\.out_proj\.(weight|bias)$", r"self_attn/out_proj/\2"),
    (r"(linear1|linear2|norm1|norm2)\.(weight|bias)$", r"\2/\3"),
]

_LOC_RULES = _COMMON_RULES + [
    (r"^bottleneck\.transf\.layers\.(\d+)\." + pat,
     r"bottleneck/layers_\1/" + rep)
    for pat, rep in _TORCH_TRANSFORMER_RULES
]

_SEP_RULES = _COMMON_RULES + [
    (r"^bottleneck\.module_list\.(\d+)\.inter\.layers\.0\." + pat,
     r"bottleneck_\1_inter/" + rep)
    for pat, rep in _TORCH_TRANSFORMER_RULES
]

# speechbrain ConformerEncoder (num_layers=1) internals -> our ConformerLayer.
# Key names transcribed from speechbrain.lobes.models.transformer.Conformer
# (+ speechbrain.nnet.attention): the layer stores raw torch modules inside
# ffn_module1/2 (nn.LayerNorm, PositionalwiseFeedForward's `ffn` Sequential
# of nn.Linear) and ConvolutionModule (nn.LayerNorm / nn.Conv1d / nn.Linear),
# while norm1/norm2 are speechbrain LayerNorm wrappers (extra `.norm.`).
# RelPosMHAXL exposes in_proj_weight (NO qkv bias), out_proj (nn.Linear),
# linear_pos (nn.Linear, no bias) and pos_bias_u/v of shape (H, E/H).
# The exact key/shape inventory is pinned by tests/fixtures_speechbrain.py.
# As above: fragments follow a one-group prefix, so internal groups are \2.
_CONFORMER_TABLE: list[tuple[str, str]] = [
    # feed-forward modules (ffn_moduleN = [nn.LayerNorm, PFFW, Dropout])
    (r"ffn_module1\.0\.(weight|bias)$", r"norm_ffn1/\2"),
    (r"ffn_module1\.1\.ffn\.0\.(weight|bias)$", r"ffn1/linear1/\2"),
    (r"ffn_module1\.1\.ffn\.3\.(weight|bias)$", r"ffn1/linear2/\2"),
    (r"ffn_module2\.0\.(weight|bias)$", r"norm_ffn2/\2"),
    (r"ffn_module2\.1\.ffn\.0\.(weight|bias)$", r"ffn2/linear1/\2"),
    (r"ffn_module2\.1\.ffn\.3\.(weight|bias)$", r"ffn2/linear2/\2"),
    # attention (norm1 = speechbrain LayerNorm wrapper; RelPosMHAXL)
    (r"norm1\.norm\.(weight|bias)$", r"norm_mhsa/\2"),
    (r"mha_layer\.in_proj_weight$", r"mhsa/in_proj_weight"),
    (r"mha_layer\.out_proj\.(weight|bias)$", r"mhsa/out_proj/\2"),
    (r"mha_layer\.linear_pos\.weight$", r"mhsa/linear_pos_weight"),
    (r"mha_layer\.pos_bias_u$", r"mhsa/pos_bias_u"),
    (r"mha_layer\.pos_bias_v$", r"mhsa/pos_bias_v"),
    # convolution module (raw torch layers inside)
    (r"convolution_module\.layer_norm\.(weight|bias)$", r"norm_conv/\2"),
    (r"convolution_module\.bottleneck\.0\.(weight|bias)$",
     r"conv/pointwise1/\2"),
    (r"convolution_module\.conv\.(weight|bias)$", r"conv/depthwise/\2"),
    (r"convolution_module\.after_conv\.0\.(weight|bias)$",
     r"conv/norm/\2"),
    (r"convolution_module\.after_conv\.2\.(weight|bias)$",
     r"conv/pointwise2/\2"),
    # layer-final norm (speechbrain wrapper)
    (r"norm2\.norm\.(weight|bias)$", r"norm_final/\2"),
]

_SEP_CONFORMER_RULES = [
    (r"^bottleneck\.module_list\.(\d+)\.intra\.layers\.0\." + pat,
     r"bottleneck_\1_intra/" + rep)
    for pat, rep in _CONFORMER_TABLE
] + [
    # encoder-level final norm (ConformerEncoder.norm, applied after the
    # single layer — distinct from the layer's norm2)
    (r"^bottleneck\.module_list\.(\d+)\.intra\.norm\.norm\.(weight|bias)$",
     r"bottleneck_\1_intra/norm_enc/\2"),
]


def convert_state_dict(state_dict: Mapping[str, np.ndarray],
                       model_name: str):
    """Convert a reference torch state dict (tensor values as numpy arrays)
    into a flax variables dict {'params': ...}.

    Returns (variables, unmatched_keys)."""
    if model_name == "SpeakerLocalization":
        rules = _LOC_RULES
    elif model_name == "SpeakerSeparation":
        rules = _SEP_RULES + _SEP_CONFORMER_RULES
    else:
        raise ValueError(model_name)

    params: dict = {}
    unmatched: list[str] = []
    for key, val in state_dict.items():
        val = np.asarray(val)
        for pat, rep in rules:
            m = re.match(pat, key)
            if m:
                path = m.expand(rep).split("/")
                # speechbrain's ConvolutionModule ends in an nn.Linear acting
                # as a pointwise conv; our block uses an actual 1x1 Conv1d
                if path[-2:] == ["pointwise2", "weight"] and val.ndim == 2:
                    val = val[:, :, None]
                _set(params, path, val)
                break
        else:
            unmatched.append(key)
    return {"params": params}, unmatched


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Load a torch .pt state dict (tensors only) into numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def load_converted(model: torch.nn.Module, state_dict: Mapping[str, np.ndarray],
                   model_name: str, strict_convert: bool = True,
                   source: str = "the state dict") -> torch.nn.Module:
    """Load a reference torch state dict into `model` in place.

    A key that no renaming rule matches, or that names no parameter of
    `model`, raises unless `strict_convert=False` (then it is skipped with a
    warning): the model would otherwise keep fresh values for it silently.
    A parameter with no counterpart in the state dict (the Conformer's qkv
    bias, which speechbrain does not have) keeps the model's own value, as
    the JAX package's merge keeps its template's."""
    variables, unmatched = convert_state_dict(state_dict, model_name)
    converted = from_jax_params(variables)
    own = model.state_dict()
    unmatched += [k for k in converted if k not in own]
    if unmatched:
        msg = (f"{len(unmatched)} unmatched torch keys converting {source}, "
               f"e.g. {unmatched[:5]}: the converted model would silently "
               f"keep fresh values for those parameters")
        if strict_convert:
            raise ValueError(msg + " (pass strict_convert=False to override)")
        print(f"[WARNING] {msg}")
    loaded = {}
    for k, v in converted.items():
        if k not in own:
            continue
        if v.shape != own[k].shape:
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs "
                             f"{tuple(own[k].shape)}")
        loaded[k] = v
    model.load_state_dict({**own, **loaded}, strict=True)
    return model


def main():
    """CLI: convert a reference torch checkpoint to the flax-layout msgpack
    param file that both packages read."""
    import argparse

    from .msgpack_writer import write_msgpack

    parser = argparse.ArgumentParser()
    parser.add_argument("torch_ckpt", type=str)
    parser.add_argument("model_name", type=str,
                        choices=["SpeakerLocalization", "SpeakerSeparation"])
    parser.add_argument("out", type=str)
    args = parser.parse_args()

    sd = load_torch_checkpoint(args.torch_ckpt)
    variables, unmatched = convert_state_dict(sd, args.model_name)
    if unmatched:
        print(f"[WARNING] {len(unmatched)} unmatched keys:")
        for k in unmatched:
            print("  ", k)
    write_msgpack(args.out, variables)
    n = sum(t.numel() for t in from_jax_params(variables).values())
    print(f"wrote {args.out}: {n / 1e6:.2f}M parameters")


if __name__ == "__main__":
    main()
