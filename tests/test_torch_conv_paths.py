"""The matrix-product forms of the networks' convolutions
(models/modules.py `conv1d_gemm`, `conv_transpose1d_gemm`, which
`GemmConv1d` and `GemmConvTranspose1d` run on every device) against
torch's convolutions, in float32 on the CPU.

The forms compute the same products as the convolutions and sum them in
another order, so they agree to float32 rounding: a relative L2 error of a
few 1e-7 over sums of up to 2112 terms.  The tolerance, 1e-5, is ten times
that and thirty times below what the same layers read with TF32 on an H100
(2.8e-4 to 3.0e-4), the precision the benchmark's comparison refuses.
"""
import pytest
import torch
from torch import nn
from torch.nn import functional as F

from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet, init_model
from acousticswarms_speech_tpu_torch.models import modules

RTOL = 1e-5


def _rel(got, want):
    return float((got - want).double().norm() / want.double().norm())


# (in channels, out channels, kernel, stride, padding, length): the layer
# patterns GemmConv1d serves, at narrow widths and short lengths
CONV_PATTERNS = {
    "preproc": (7, 16, 1, 1, 0, 512),
    "reference_bypass": (1, 32, 33, 16, 16, 512),
    "mask_encoder": (16, 32, 33, 16, 16, 512),
    "mask_encoder_ragged": (16, 32, 33, 16, 16, 500),
}


@pytest.mark.parametrize("pattern", sorted(CONV_PATTERNS))
def test_conv1d_gemm_matches_conv1d(pattern):
    c_in, c_out, k, s, p, L = CONV_PATTERNS[pattern]
    gen = torch.Generator().manual_seed(len(pattern))
    x = torch.randn(3, c_in, L, generator=gen)
    w = torch.randn(c_out, c_in, k, generator=gen) / (c_in * k) ** 0.5
    b = torch.randn(c_out, generator=gen)
    want = F.conv1d(x, w, b, stride=s, padding=p)
    got = modules.conv1d_gemm(x, w, b, s, p)
    assert got.shape == want.shape
    assert _rel(got, want) < RTOL
    assert _rel(modules.conv1d_gemm(x, w, None, s, p),
                F.conv1d(x, w, None, stride=s, padding=p)) < RTOL


@pytest.mark.parametrize("c_in,c_out,k", [(64, 128, 2), (16, 32, 2),
                                          (32, 16, 4), (8, 16, 4)])
def test_conv_transpose1d_gemm_matches(c_in, c_out, k):
    """The decoders' upsampling, kernel = stride 2 and 4."""
    gen = torch.Generator().manual_seed(c_in * k)
    x = torch.randn(3, c_in, 37, generator=gen)
    w = torch.randn(c_in, c_out, k, generator=gen) / c_in ** 0.5
    b = torch.randn(c_out, generator=gen)
    want = F.conv_transpose1d(x, w, b, stride=k)
    got = modules.conv_transpose1d_gemm(x, w, b)
    assert got.shape == want.shape == (3, c_out, 37 * k)
    assert got.is_contiguous()
    assert _rel(got, want) < RTOL


def _torch_convolutions(monkeypatch):
    """The layers as torch's own convolutions."""
    monkeypatch.setattr(modules.GemmConv1d, "forward", nn.Conv1d.forward)
    monkeypatch.setattr(modules.GemmConvTranspose1d, "forward",
                        nn.ConvTranspose1d.forward)


NETS = {
    "spotnet": lambda: (SpotNet(channels=8, encoder_channels=32,
                                residual_layers=2, num_head=2, ffw_dim=16,
                                num_transformer_layers=1),
                        (torch.randn(2, 7, 1000), torch.tensor(
                            [[1.0, 0.0], [0.0, 1.0]]))),
    "sepnet": lambda: (SepNet(max_speakers=5, channels=8, encoder_channels=32,
                              residual_layers=1, num_head=2, ffw_dim=16,
                              bottleneck_layers=1, bottleneck_ksize=7),
                       (torch.randn(1, 3 * 7, 1000), torch.tensor([3]))),
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_narrow_network_with_the_path_on_and_off(net, monkeypatch):
    """A narrow network with the matrix-product forms everywhere they serve
    and with torch's convolutions in their place."""
    torch.manual_seed(0)
    model, args = NETS[net]()
    init_model(model.eval(), seed=3)
    with torch.no_grad():
        got = model(*args)
        _torch_convolutions(monkeypatch)
        want = model(*args)
    assert got.shape == want.shape
    assert not torch.equal(got, want)  # the forms ran
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("kwargs", [
    {"groups": 2}, {"dilation": 2}, {"padding_mode": "reflect", "padding": 1},
    {"padding": "same"}])
def test_gemm_conv1d_refuses_what_it_does_not_compute(kwargs):
    with pytest.raises(ValueError, match="GemmConv"):
        modules.GemmConv1d(4, 8, 3, **kwargs)


@pytest.mark.parametrize("kwargs", [
    {"kernel_size": 4, "stride": 2}, {"padding": 1}, {"output_padding": 1,
                                                    "dilation": 2},
    {"groups": 2}, {"bias": False}])
def test_gemm_conv_transpose1d_refuses_what_it_does_not_compute(kwargs):
    args = {"kernel_size": 2, "stride": 2, **kwargs}
    with pytest.raises(ValueError, match="GemmConv"):
        modules.GemmConvTranspose1d(4, 8, **args)
