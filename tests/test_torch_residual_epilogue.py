"""The epilogue of a dilated residual layer (ops/residual_epilogue.py) and
the dispatch in models/modules.py DilatedResidualLayer, on the CPU.

The plain version, with the convolution's bias moved into it, is the
layer's composition to the bit; the layer runs that composition on every
input the fused kernel K5 does not take (CPU, meta, bfloat16, gradients
on), and its parameters keep their names.  K5 itself runs only on a card:
tests/test_torch_kernels_gpu.py.
"""
import pytest
import torch
from torch.nn import functional as F

from acousticswarms_speech_tpu_torch.models import modules
from acousticswarms_speech_tpu_torch.ops.residual_epilogue import (
    residual_epilogue_cuda,
    residual_epilogue_plain,
)


def _layer(C, k, dilation, seed):
    """A layer with every parameter drawn, the norm's affine step too."""
    gen = torch.Generator().manual_seed(seed)
    layer = modules.DilatedResidualLayer(C, k, dilation)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return layer, gen


# (channels, kernel, dilation, batch, length): SpotNet's 7-wide layers
# (dilations 1, 7, 49) and SepNet's 5-wide ones (1, 2, 4), narrow and short
LAYERS = [(8, 7, 1, 2, 300), (16, 7, 7, 3, 257), (32, 7, 49, 1, 400),
          (8, 5, 2, 3, 301), (64, 5, 4, 2, 128)]


def _composition(z, x, conv_bias, norm):
    """The epilogue as the layer wrote it out in PyTorch operations before
    the fused kernel: bias, ReLU, residual add, then ChannelLayerNorm's
    var_mean over C and each affine step apart."""
    y = F.relu(z + conv_bias[:, None]) + x
    var, mean = torch.var_mean(y, dim=1, correction=0, keepdim=True)
    return (y - mean) * torch.rsqrt(var + norm.eps) \
        * norm.weight[None, :, None] + norm.bias[None, :, None]


@pytest.mark.parametrize("C,k,d,B,T", LAYERS)
def test_plain_is_the_layers_composition(C, k, d, B, T):
    """With the bias moved out of the convolution, the plain version is
    norm(relu(conv(x)) + x) to the bit, and the layer's own output (bias in
    the convolution) to float32 rounding."""
    layer, gen = _layer(C, k, d, C + k + d)
    x = torch.randn(B, C, T, generator=gen)
    conv = layer.conv
    with torch.no_grad():
        z = F.conv1d(x, conv.weight, None, conv.stride, conv.padding,
                     conv.dilation)
        got = residual_epilogue_plain(z, x, conv.bias, layer.norm.weight,
                                      layer.norm.bias, layer.norm.eps)
        assert torch.equal(got, _composition(z, x, conv.bias, layer.norm))
        torch.testing.assert_close(got, layer(x), rtol=1e-5, atol=1e-5)


def _refuse_kernel(monkeypatch):
    def refuse(*args):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(modules, "residual_epilogue_cuda", refuse)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_takes_the_plain_path_on_cpu(monkeypatch, dtype, grad):
    _refuse_kernel(monkeypatch)
    layer, gen = _layer(16, 7, 7, 1)
    layer = layer.to(dtype)
    x = torch.randn(2, 16, 200, generator=gen).to(dtype)
    with torch.set_grad_enabled(grad):
        got = layer(x)
        want = layer.norm(F.relu(layer.conv(x)) + x)
    assert got.dtype == dtype and torch.equal(got, want)
    assert got.requires_grad == grad


def test_layer_takes_the_plain_path_on_meta(monkeypatch):
    """Meta tensors (the benchmark counts FLOPs on them) run the
    composition, convolution bias included."""
    _refuse_kernel(monkeypatch)
    layer = modules.DilatedResidualLayer(32, 7, 49).to("meta")
    with torch.no_grad():
        out = layer(torch.empty(4, 32, 1000, device="meta"))
    assert out.device.type == "meta" and out.shape == (4, 32, 1000)


def test_weights_keep_their_names():
    """The layer's parameters are the JAX package's tree's names, so the
    release weights load unchanged; a state dict loads strictly."""
    seq = modules.DilatedResidualSequence(8, 7, 3, 7)
    names = [f"seq_{i}.{m}.{p}" for i in range(3)
             for m in ("conv", "norm") for p in ("weight", "bias")]
    assert sorted(seq.state_dict()) == sorted(names)
    other, _ = _layer(8, 7, 1, 5)
    fresh = modules.DilatedResidualLayer(8, 7, 1)
    fresh.load_state_dict(other.state_dict(), strict=True)
    x = torch.randn(1, 8, 64)
    with torch.no_grad():
        assert torch.equal(fresh(x), other(x))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never runs the plain version itself."""
    z = torch.zeros(1, 8, 16)
    v = torch.zeros(8)
    before = residual_epilogue_cuda.launches
    with pytest.raises(ValueError):
        residual_epilogue_cuda(z, z, v, v, v, 1e-5)
    assert residual_epilogue_cuda.launches == before
