"""The epilogue of a U-Net block (ops/block_epilogue.py) and the dispatch in
models/modules.py EncoderBlock and DecoderBlock, on the CPU.

The plain version is the blocks' old composition to the bit (the encoders'
conv1 bias, or the decoders' window-embedding gate, then GroupNorm(2) and
GLU); the blocks run it on every input the fused kernel K6 does not take
(CPU, meta, bfloat16, gradients on), and their parameters keep their
names.  K6 itself runs only on a card: tests/test_torch_kernels_gpu.py.
"""
import pytest
import torch
from torch.nn import functional as F

from acousticswarms_speech_tpu_torch.models import modules
from acousticswarms_speech_tpu_torch.ops.block_epilogue import (
    block_epilogue_cuda,
    block_epilogue_plain,
)


def _composition(e, norm, bias=None, gate=None):
    """The epilogue as the blocks wrote it out in PyTorch operations before
    the fused kernel: the bias in the convolution's output or the gate's
    product, GroupNorm in float32, then GLU's halves."""
    if bias is not None:
        e = e + bias[:, None]
    if gate is not None:
        e = gate[:, :, None] * e
    y = F.group_norm(e.float(), 2, norm.weight.float(), norm.bias.float(),
                     norm.eps).to(e.dtype)
    a, b = y.chunk(2, dim=1)
    return a * torch.sigmoid(b)


def _drawn(module, seed):
    """`module` with every parameter drawn, the norms' affine steps too."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return module, gen


# (block, gated, B, 2C, T): encoder (conv1 bias) and decoder (no gate, or
# SpotNet's gate), narrow and short; 2C * T / 2 below and above
# GroupNorm's 512 threads a row; B = 1 is a partial sweep chunk
CASES = [("encoder", False, 3, 16, 40), ("encoder", True, 2, 8, 300),
         ("encoder", True, 1, 32, 9), ("decoder", False, 2, 16, 257),
         ("decoder", True, 3, 8, 64), ("decoder", True, 1, 64, 1001)]


@pytest.mark.parametrize("block,gated,B,C2,T", CASES)
def test_plain_is_the_blocks_composition(block, gated, B, C2, T):
    norm, gen = _drawn(modules.GroupNorm(2, C2), B * C2 + T)
    e = torch.randn(B, C2, T, generator=gen)
    extra = {}
    if block == "encoder":
        extra["bias"] = torch.randn(C2, generator=gen)
    elif gated:
        extra["gate"] = torch.randn(B, C2, generator=gen)
    got = block_epilogue_plain(e, norm.weight, norm.bias, norm.eps, **extra)
    assert got.shape == (B, C2 // 2, T)
    with torch.no_grad():
        assert torch.equal(got, _composition(e, norm, **extra))


def _encoder(gated, seed):
    return _drawn(modules.EncoderBlock(8, 8, 7, 2, 2, 7,
                                       use_window_embedding=gated), seed)


def _decoder(gated, seed):
    return _drawn(modules.DecoderBlock(16, 8, 2, 7, 2, 7,
                                       use_window_embedding=gated), seed)


def _old_encoder(block, x, w=None):
    """EncoderBlock.forward as it was before K6."""
    x = block.res(x)
    if block.embed1 is not None:
        x = block.embed1(w[:, :, None]) * x
    y = block.norm1(block.conv1(x))
    a, b = y.chunk(2, dim=1)
    return a * torch.sigmoid(b)


def _old_decoder(block, x, skip, w=None):
    """DecoderBlock.forward as it was before K6."""
    x = block.upsample_conv(x + skip)
    if block.embed1 is not None:
        x = block.embed1(w[:, :, None]) * x
    y = block.norm1(x)
    a, b = y.chunk(2, dim=1)
    return block.res(a * torch.sigmoid(b))


def _run(kind, gated, dtype, seed, device="cpu"):
    """(new forward, old forward) of a drawn block on drawn inputs."""
    if kind == "encoder":
        block, gen = _encoder(gated, seed)
        args = [torch.randn(2, 8, 96, generator=gen)]
    else:
        block, gen = _decoder(gated, seed)
        args = [torch.randn(2, 16, 48, generator=gen),
                torch.randn(2, 16, 48, generator=gen)]
    w = torch.randn(2, 2, generator=gen) if gated else None
    block = block.to(device=device, dtype=dtype)
    args = [a.to(device=device, dtype=dtype) for a in args]
    w = None if w is None else w.to(device=device, dtype=dtype)
    old = _old_encoder if kind == "encoder" else _old_decoder
    return block(*args, w), old(block, *args, w)


def _refuse_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(modules, "block_epilogue_cuda", refuse)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,gated", [("encoder", True), ("decoder", True),
                                        ("decoder", False)])
def test_blocks_take_the_plain_path_on_cpu(monkeypatch, kind, gated, dtype,
                                           grad):
    """On the CPU, in float32 and bfloat16, with gradients on or off, a
    block gives its old forward to the bit and never calls the kernel."""
    _refuse_kernel(monkeypatch)
    with torch.set_grad_enabled(grad):
        got, want = _run(kind, gated, dtype, 3)
    assert got.dtype == dtype and torch.equal(got, want)
    assert got.requires_grad == grad


def test_blocks_take_the_plain_path_on_meta(monkeypatch):
    """Meta tensors (the benchmark counts FLOPs on them) run the
    composition, the convolution's bias included."""
    _refuse_kernel(monkeypatch)
    enc = modules.EncoderBlock(8, 8, 7, 2, 2, 7,
                               use_window_embedding=True).to("meta")
    dec = modules.DecoderBlock(16, 8, 2, 7, 2, 7,
                               use_window_embedding=True).to("meta")
    w = torch.empty(4, 2, device="meta")
    with torch.no_grad():
        h = enc(torch.empty(4, 8, 1000, device="meta"), w)
        out = dec(torch.empty(4, 16, 250, device="meta"),
                  torch.empty(4, 16, 250, device="meta"), w)
    assert h.device.type == "meta" and h.shape == (4, 8, 500)
    assert out.device.type == "meta" and out.shape == (4, 8, 500)


def test_weights_keep_their_names():
    """The blocks' parameters are the JAX package's tree's names, so the
    release weights load unchanged; a state dict loads strictly and the
    loaded block gives the same output."""
    enc, _ = _encoder(True, 5)
    dec, _ = _decoder(True, 6)
    epilogue = {"encoder": ["embed1.weight", "embed1.bias", "conv1.weight",
                            "conv1.bias", "norm1.weight", "norm1.bias"],
                "decoder": ["upsample_conv.weight", "upsample_conv.bias",
                            "embed1.weight", "embed1.bias", "norm1.weight",
                            "norm1.bias"]}
    for kind, block in (("encoder", enc), ("decoder", dec)):
        names = [n for n in block.state_dict() if not n.startswith("res.")]
        assert sorted(names) == sorted(epilogue[kind])
    fresh = modules.EncoderBlock(8, 8, 7, 2, 2, 7, use_window_embedding=True)
    fresh.load_state_dict(enc.state_dict(), strict=True)
    x, w = torch.randn(1, 8, 64), torch.randn(1, 2)
    with torch.no_grad():
        assert torch.equal(fresh(x, w), enc(x, w))


_E, _V, _G = (2, 8, 16), (8,), (2, 8)
# (e, norm weight, norm bias, bias, gate shapes; the error and its message)
REFUSED = [
    ((_E, _V, _V, None, None), ValueError, "CUDA device"),
    ((_E, _V, _V, _V, _G), ValueError, "a bias or a gate"),
    (((8, 16), _V, _V, None, None), ValueError, "shapes"),
    (((2, 7, 16), (7,), (7,), None, None), ValueError, "shapes"),
    (((2, 8, 1), _V, _V, None, None), ValueError, "shapes"),
    ((_E, (4,), _V, None, None), ValueError, "shapes"),
    ((_E, _V, _V, (4,), None), ValueError, "shapes"),
    ((_E, _V, _V, None, (8,)), ValueError, "shapes"),
    ((_E, _V, _V, None, (3, 8)), ValueError, "shapes"),
]


@pytest.mark.parametrize("shapes,error,match", REFUSED)
def test_cuda_wrapper_refuses_cpu_and_ill_shaped_tensors(shapes, error,
                                                         match):
    """The kernel's wrapper never runs the plain version itself and counts
    no launch for what it refuses: CPU tensors, a bias with a gate, and
    shapes other than e (B, 2C, T > 1), (2C,) vectors and a (B, 2C) gate."""
    e, w, b, bias, gate = [None if s is None else torch.zeros(s)
                           for s in shapes]
    before = block_epilogue_cuda.launches
    with pytest.raises(error, match=match):
        block_epilogue_cuda(e, w, b, 1e-5, bias=bias, gate=gate)
    assert block_epilogue_cuda.launches == before


def test_cuda_wrapper_refuses_other_dtypes_and_strides():
    before = block_epilogue_cuda.launches
    e, v = torch.zeros(2, 8, 16), torch.zeros(8)
    with pytest.raises(TypeError):
        block_epilogue_cuda(e.double(), v, v, 1e-5)
    with pytest.raises(TypeError):
        block_epilogue_cuda(e, v.half(), v, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        block_epilogue_cuda(e.transpose(1, 2).contiguous().transpose(1, 2),
                            v, v, 1e-5)
    assert block_epilogue_cuda.launches == before
