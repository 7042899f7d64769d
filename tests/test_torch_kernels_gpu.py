"""The hand-written CUDA kernels of acousticswarms_speech_tpu_torch against
their plain PyTorch versions, and the networks' matrix-product convolutions
against torch's convolutions, on the card.

Every test here carries the `gpu` marker and skips without a CUDA device
(decided inside a fixture, so every worker collects the same tests).  This
file imports neither JAX nor the JAX package, so it runs on a machine that
has neither:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from acousticswarms_speech_tpu_torch.ops import roll_kernel  # noqa: E402
from acousticswarms_speech_tpu_torch.ops.shift import (  # noqa: E402
    roll_channels_batch,
    roll_channels_batch_plain,
    roll_zero_fill_batch,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda")


def _shifts(B, T, gen, M=7):
    s = torch.randint(-T + 1, T, (B, M), generator=gen, dtype=torch.int32)
    for k, v in enumerate([-(T - 1), -5, 0, 3, T - 1][:B]):
        s[k] = v
    return s


@pytest.mark.parametrize("M", [7, 10])
@pytest.mark.parametrize("B,T", [(1, 1), (3, 5), (32, 72000), (37, 72000),
                                 (5, 144000), (512, 72000), (4, 1023),
                                 (7000, 1024)])
def test_roll_kernel_matches_plain(cuda, B, T, M):
    """Exact equality: the kernel copies samples.  T = 1023 and 5 take the
    scalar-store path, the others the 16-byte one.  B = 7000 at M = 10 puts
    70000 rows past the grid's y limit of 65535 (287 MB out), so blocks
    walk more than one row."""
    gen = torch.Generator().manual_seed(B * 100003 + T + M)
    mix = torch.randn(M, T, generator=gen).to(cuda)
    shifts = _shifts(B, T, gen, M).to(cuda)
    before = roll_kernel.roll_channels_batch_cuda.launches
    got = roll_channels_batch(mix, shifts)
    torch.cuda.synchronize()
    assert roll_kernel.roll_channels_batch_cuda.launches == before + 1
    assert torch.equal(got, roll_channels_batch_plain(mix, shifts))


def test_roll_zero_fill_on_card(cuda):
    gen = torch.Generator().manual_seed(1)
    mix = torch.randn(7, 4096, generator=gen).to(cuda)
    shifts = _shifts(6, 4096, gen).to(cuda)
    got = roll_zero_fill_batch(mix, shifts).cpu()
    want = roll_zero_fill_batch(mix.cpu(), shifts.cpu())
    assert torch.equal(got, want)


def test_roll_kernel_rejects_bad_inputs(cuda):
    mix = torch.zeros(7, 64, device=cuda)
    shifts = torch.zeros(2, 7, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        roll_kernel.roll_channels_batch_cuda(mix.double(), shifts)
    with pytest.raises(ValueError):
        roll_kernel.roll_channels_batch_cuda(mix.t(), shifts)
    with pytest.raises(ValueError):
        roll_kernel.roll_channels_batch_cuda(mix, shifts[:, :5].contiguous())


def test_roll_kernel_counts_launches_and_runs_in_threads(cuda):
    """Two threads launch the kernel at once: every result equals the
    plain version and every launch is counted once."""
    import threading

    gen = torch.Generator().manual_seed(5)
    mix = torch.randn(7, 9000, generator=gen).to(cuda)
    shifts = [_shifts(11, 9000, gen).to(cuda) for _ in range(2)]
    before = roll_kernel.roll_channels_batch_cuda.launches
    bad = []

    def run(k):
        for _ in range(50):
            got = roll_kernel.roll_channels_batch_cuda(mix, shifts[k])
            if not torch.equal(got, roll_channels_batch_plain(mix, shifts[k])):
                bad.append(k)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad
    assert roll_kernel.roll_channels_batch_cuda.launches - before == 100


def test_roll_ab_times_two_sources(cuda, tmp_path):
    """scripts/roll_ab builds a second copy of the kernel's source, holds it
    equal to the plain version and times both versions at each shape, twice
    a round (one order, then the reverse)."""
    import shutil

    from acousticswarms_speech_tpu_torch.scripts import roll_ab

    other = tmp_path / "copy.cu"
    shutil.copy(roll_kernel.SOURCE, other)
    res = roll_ab.compare({"current": roll_kernel.SOURCE, "copy": str(other)},
                          [(37, 10, 4096)], rounds=2, reps=2)
    times = res[(37, 10, 4096)]
    assert sorted(times) == ["copy", "current"]
    assert all(len(v) == 4 and min(v) > 0 for v in times.values())


# The matrix-product forms of SpotNet's convolutions (models/modules.py
# GemmConv1d, GemmConvTranspose1d) against torch's convolutions in float64
# at release widths, on sweep chunks of 64, 17 and 1 candidates of 72000
# samples (72192 after SpotNet's pad): a chunk holds 1 to 64.  Float32
# with TF32 off: the same products summed in another order, a relative L2
# error of about 1e-7; with TF32 on the products read 2.8e-4 to 3.0e-4 (an
# H100), so the tolerance 1e-5 fails it.
GEMM_RTOL = 1e-5


def _spotnet_release_widths(cuda):
    from acousticswarms_speech_tpu_torch.models import SpotNet, init_model

    return init_model(SpotNet().eval(), seed=0).to(cuda)


def _gemm_layers(net, batch):
    """(name, module, input shape) of each layer with a matrix-product form,
    at one chunk of `batch` candidates."""
    T = 72192
    shapes = {"preproc": (batch, 7, T), "reference_bypass": (batch, 1, T),
              "mask_encoder": (batch, 64, T)}
    for i in range(net.depth):  # decoder i upsamples to level depth - 1 - i
        up = getattr(net, f"decoder_{i}").upsample_conv
        out_len = T // math.prod(net.stride_list[: net.depth - 1 - i])
        shapes[f"decoder_{i}.upsample_conv"] = (
            batch, up.in_channels, out_len // up.stride[0])
    modules = dict(net.named_modules())
    return [(name, modules[name], shape) for name, shape in shapes.items()]


def _rel(got, want):
    return float((got - want).double().norm() / want.double().norm())


def _exact(m, x):
    """The layer as torch's own convolution in float64."""
    from torch.nn import functional as F

    x, w, b = x.double(), m.weight.double(), m.bias.double()
    if isinstance(m, torch.nn.ConvTranspose1d):
        return F.conv_transpose1d(x, w, b, stride=m.stride)
    return F.conv1d(x, w, b, stride=m.stride, padding=m.padding)


@pytest.mark.parametrize("batch", [64, 17, 1])
def test_gemm_convolutions_match_plain_and_tf32_fails(cuda, batch):
    net = _spotnet_release_widths(cuda)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator(device=cuda).manual_seed(7)
    errors, tf32_errors = {}, {}
    try:
        with torch.no_grad():
            for name, m, shape in _gemm_layers(net, batch):
                x = torch.randn(shape, device=cuda, generator=gen)
                want = _exact(m, x)
                torch.backends.cuda.matmul.allow_tf32 = False
                errors[name] = _rel(m(x), want)
                torch.backends.cuda.matmul.allow_tf32 = True
                tf32_errors[name] = _rel(m(x), want)
                del x, want
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    assert len(errors) == 8
    assert max(errors.values()) < GEMM_RTOL, errors
    # The input projection's 7-term products stay float32 with TF32 on
    # (its error read 0 on an H100): cuBLAS takes no TF32 kernel for them.
    assert tf32_errors.pop("preproc") < GEMM_RTOL
    assert min(tf32_errors.values()) > GEMM_RTOL, tf32_errors


def test_spotnet_chunk_runs_no_legacy_convolution(cuda, tmp_path):
    """A profiled SpotNet call on one chunk launches neither cuDNN's legacy
    `implicit_convolve_sgemm` nor its transposed `dgrad_engine` for the
    layers that have a matrix-product form (SpotNet's `output_decoder`,
    kernel 33 at stride 16, overlapping, stays on the latter)."""
    import json

    net = _spotnet_release_widths(cuda)
    x = torch.randn(64, 7, 72000, device=cuda)
    w = torch.tensor([[0.0, 1.0]], device=cuda).expand(64, 2)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=False,
            allow_tf32=False):
        net(x, w)
        with torch.profiler.profile(activities=acts) as prof:
            net(x, w)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    assert names, "the profiler saw no kernel"
    assert not [n for n in names if "implicit_convolve_sgemm" in n]
    assert sum("dgrad_engine" in n for n in names) <= 1


# K5, the fused epilogue of a dilated residual layer (ops/residual_epilogue.py,
# csrc/residual_epilogue.cu), against its plain version and a float64 copy.
# (batch, C, T) of the residual stacks on the main path: SpotNet's five
# levels at sweep chunks of 64, 17 and 1 candidates (72192 samples after its
# pad), SepNet's four at 3 and 5 talkers (72000 samples).
SPOT_LEVELS = [(64, 72192), (64, 36096), (128, 18048), (256, 4512), (512, 1128)]
SEP_LEVELS = [(64, 72000), (64, 36000), (128, 18000), (256, 4500)]
EPILOGUE_SHAPES = (
    [(n, C, T) for n in (64, 17, 1) for C, T in SPOT_LEVELS]
    + [(s, C, T) for s in (3, 5) for C, T in SEP_LEVELS]
    # the scalar path (T not a multiple of 4: torch.var_mean then reads 2 or
    # 1 outputs a thread and splits C otherwise); C not a power of two; few
    # outputs (narrow reduction blocks); the most channels the kernel takes
    + [(3, 64, 1001), (2, 256, 999), (2, 512, 258), (2, 48, 1000),
       (1, 64, 20), (1, 512, 8)])


def _epilogue_inputs(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    B, C, T = shape
    z = torch.randn(B, C, T, device=device, generator=gen)
    x = torch.randn(B, C, T, device=device, generator=gen)
    cb = torch.randn(C, device=device, generator=gen) * 0.3
    w = 1 + torch.randn(C, device=device, generator=gen) * 0.3
    b = torch.randn(C, device=device, generator=gen) * 0.3
    return z, x, cb, w, b


def _epilogue_float64(z, x, cb, w, b, eps):
    y = (z.double() + cb.double()[:, None]).clamp_min_(0).add_(x.double())
    var, mean = torch.var_mean(y, dim=1, correction=0, keepdim=True)
    return y.sub_(mean).mul_(torch.rsqrt(var + eps)) \
        .mul_(w.double()[:, None]).add_(b.double()[:, None])


@pytest.mark.parametrize("shape", EPILOGUE_SHAPES)
def test_residual_epilogue_matches_plain_and_float64(cuda, shape):
    """K5 gives the plain version's bits (torch.var_mean's sums in its
    order, each affine step rounded alone), so its relative L2 error
    against float64 is the plain version's, within the factor 1.5 that a
    kernel with its own order of the sums would have to keep."""
    from acousticswarms_speech_tpu_torch.ops.residual_epilogue import (
        residual_epilogue_cuda,
        residual_epilogue_plain,
    )

    args = _epilogue_inputs(shape, cuda, sum(shape))
    before = residual_epilogue_cuda.launches
    got = residual_epilogue_cuda(*args, 1e-5)
    torch.cuda.synchronize()
    assert residual_epilogue_cuda.launches == before + 1
    plain = residual_epilogue_plain(*args, 1e-5)
    exact = _epilogue_float64(*args, 1e-5)
    err, plain_err = _rel(got, exact), _rel(plain, exact)
    assert torch.isfinite(got).all()
    assert err <= 1.5 * plain_err, (err, plain_err)
    assert torch.equal(got, plain), _rel(got, plain)


@pytest.mark.parametrize("k,dilation", [(7, 1), (7, 7), (7, 49), (5, 2), (5, 4)])
def test_residual_layer_kernel_is_the_composition(cuda, k, dilation):
    """A DilatedResidualLayer on the card (float32, gradients off) runs its
    convolution without the bias and K5, and gives to the bit what its
    composition with the bias in the convolution gives."""
    from torch.nn import functional as F

    from acousticswarms_speech_tpu_torch.models.modules import DilatedResidualLayer
    from acousticswarms_speech_tpu_torch.ops.residual_epilogue import \
        residual_epilogue_cuda

    torch.manual_seed(dilation)
    layer = DilatedResidualLayer(128, k, dilation).to(cuda)
    with torch.no_grad():
        layer.norm.weight.normal_(1, 0.3)
        layer.norm.bias.normal_(0, 0.3)
        x = torch.randn(17, 128, 18048, device=cuda)
        before = residual_epilogue_cuda.launches
        got = layer(x)
        assert residual_epilogue_cuda.launches == before + 1
        assert torch.equal(got, layer.norm(F.relu(layer.conv(x)) + x))


def test_residual_epilogue_unaligned_input(cuda):
    """A contiguous view 4 bytes past an allocation's start takes the
    scalar path and still matches the plain version."""
    from acousticswarms_speech_tpu_torch.ops.residual_epilogue import (
        residual_epilogue_cuda,
        residual_epilogue_plain,
    )

    z, x, cb, w, b = _epilogue_inputs((2, 64, 1024), cuda, 11)
    zs = torch.empty(z.numel() + 1, device=cuda)[1:].view_as(z).copy_(z)
    assert zs.is_contiguous() and zs.data_ptr() % 16 != 0
    got = residual_epilogue_cuda(zs, x, cb, w, b, 1e-5)
    assert _rel(got, residual_epilogue_plain(z, x, cb, w, b, 1e-5)) < 1e-6


def test_residual_epilogue_rejects_bad_inputs(cuda):
    from acousticswarms_speech_tpu_torch.ops.residual_epilogue import (
        MAX_CHANNELS,
        residual_epilogue_cuda,
    )

    z, x, cb, w, b = _epilogue_inputs((2, 64, 256), cuda, 3)
    before = residual_epilogue_cuda.launches
    with pytest.raises(TypeError):
        residual_epilogue_cuda(z.double(), x, cb, w, b, 1e-5)
    with pytest.raises(TypeError):
        residual_epilogue_cuda(z, x, cb.half(), w, b, 1e-5)
    with pytest.raises(ValueError):  # shapes
        residual_epilogue_cuda(z, x[:, :, :128].contiguous(), cb, w, b, 1e-5)
    with pytest.raises(ValueError):
        residual_epilogue_cuda(z, x, cb[:32], w, b, 1e-5)
    with pytest.raises(ValueError):
        residual_epilogue_cuda(z[0], x[0], cb, w, b, 1e-5)
    with pytest.raises(ValueError):  # strides
        residual_epilogue_cuda(z.transpose(1, 2).contiguous().transpose(1, 2),
                               x, cb, w, b, 1e-5)
    with pytest.raises(ValueError):  # devices
        residual_epilogue_cuda(z, x.cpu(), cb, w, b, 1e-5)
    big = _epilogue_inputs((1, MAX_CHANNELS + 1, 64), cuda, 4)
    with pytest.raises(ValueError):  # channels
        residual_epilogue_cuda(*big, 1e-5)
    assert residual_epilogue_cuda.launches == before


def test_residual_epilogue_counts_launches_and_dispatch(cuda):
    """One SpotNet chunk launches K5 once for each of its 30 residual
    layers and one SepNet forward 24 times, each launch counted on the
    wrapper; with gradients on, or in bfloat16, a layer runs the plain
    composition."""
    from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet, init_model
    from acousticswarms_speech_tpu_torch.models.modules import DilatedResidualLayer
    from acousticswarms_speech_tpu_torch.ops.residual_epilogue import \
        residual_epilogue_cuda

    def launches(fn):
        before = residual_epilogue_cuda.launches
        fn()
        torch.cuda.synchronize()
        return residual_epilogue_cuda.launches - before

    spot = init_model(SpotNet().eval(), seed=0).to(cuda)
    x = torch.randn(4, 7, 72000, device=cuda)
    w = torch.tensor([[0.0, 1.0]], device=cuda).expand(4, 2)
    with torch.no_grad():
        assert launches(lambda: spot(x, w)) == 30
    sep = init_model(SepNet().eval(), seed=0).to(cuda)
    mix = torch.randn(1, 3 * 7, 72000, device=cuda)
    with torch.no_grad():
        assert launches(lambda: sep(mix, torch.tensor([3], device=cuda))) == 24

    layer = DilatedResidualLayer(64, 7, 7).to(cuda)
    h = torch.randn(2, 64, 4096, device=cuda)
    with torch.enable_grad():
        assert launches(lambda: layer(h).sum().backward()) == 0
    with torch.no_grad():
        assert launches(lambda: layer.to(torch.bfloat16)(h.bfloat16())) == 0


def test_residual_epilogue_runs_in_threads(cuda):
    """Two threads launch K5 at once: every result equals a lone launch's
    to the bit (no atomics: the sums run in a fixed order) and every launch
    is counted once."""
    import threading

    from acousticswarms_speech_tpu_torch.ops.residual_epilogue import \
        residual_epilogue_cuda

    inputs = [_epilogue_inputs(s, cuda, k)
              for k, s in enumerate([(4, 512, 1128), (5, 64, 9000)])]
    alone = [residual_epilogue_cuda(*a, 1e-5) for a in inputs]
    torch.cuda.synchronize()
    before = residual_epilogue_cuda.launches
    bad = []

    def run(k):
        for _ in range(50):
            if not torch.equal(residual_epilogue_cuda(*inputs[k], 1e-5),
                               alone[k]):
                bad.append(k)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not bad
    assert residual_epilogue_cuda.launches - before == 100


# K6, the fused epilogue of a U-Net block (ops/block_epilogue.py,
# csrc/block_epilogue.cu): (kind, B, 2C, T) of e at every launch on the main
# path.  SpotNet's five encoders (conv1 bias) and five decoders (gate) at a
# sweep chunk of 64 candidates and a partial chunk of 17 (72192 samples
# after its pad), and at the heads' full 3 s (144384) for 5 heads; SepNet's
# four encoders (bias) and four decoders (neither) at 2 and 5 talkers.
def _block_shapes(B, T, levels, kinds):
    enc = [(kinds[0], B, c2, T // s) for c2, s in levels]
    dec = [(kinds[1], B, c2, T // s) for c2, s in reversed(levels[:-1])]
    return enc + dec + [(kinds[1], B, levels[0][0], T)]


SPOT_BLOCKS = [(128, 2), (256, 4), (512, 16), (1024, 64), (2048, 256)]
SEP_BLOCKS = [(128, 2), (256, 4), (512, 16), (1024, 64)]
BLOCK_SHAPES = (
    _block_shapes(64, 72192, SPOT_BLOCKS, ("bias", "gate"))
    + _block_shapes(17, 72192, SPOT_BLOCKS, ("bias", "gate"))
    + _block_shapes(5, 144384, SPOT_BLOCKS, ("bias", "gate"))
    + [s for n in (2, 5)
       for s in _block_shapes(n, 72000, SEP_BLOCKS, ("bias", "plain"))]
    # 32 threads a row (C * T < 512); T not a multiple of 4 (the scalar
    # path); the shortest T; one item
    + [("bias", 3, 16, 40), ("gate", 2, 64, 15), ("plain", 4, 1024, 2),
       ("gate", 1, 256, 999), ("plain", 3, 128, 1001)])


def _block_inputs(kind, B, C2, T, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    e = torch.randn(B, C2, T, device=device, generator=gen)
    w = 1 + torch.randn(C2, device=device, generator=gen) * 0.3
    b = torch.randn(C2, device=device, generator=gen) * 0.3
    extra = {}
    if kind == "bias":
        extra["bias"] = torch.randn(C2, device=device, generator=gen) * 0.3
    elif kind == "gate":
        extra["gate"] = torch.randn(B, C2, device=device, generator=gen)
    return (e, w, b, 1e-5), extra


def _block_float64(e, w, b, eps, bias=None, gate=None):
    e = e.double()
    if bias is not None:
        e = e + bias.double()[:, None]
    if gate is not None:
        e = gate.double()[:, :, None] * e
    y = torch.nn.functional.group_norm(e, 2, w.double(), b.double(), eps)
    a, g = y.chunk(2, dim=1)
    return a * torch.sigmoid(g)


@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=str)
def test_block_epilogue_matches_plain_and_float64(cuda, shape):
    """K6 gives the plain version's bits (GroupNorm's statistics in its
    order and tree, each later step rounded as its kernel rounds it), so
    its relative L2 error against float64 is the plain version's."""
    from acousticswarms_speech_tpu_torch.ops.block_epilogue import (
        block_epilogue_cuda,
        block_epilogue_plain,
    )

    args, extra = _block_inputs(*shape, cuda, sum(shape[1:]))
    before = block_epilogue_cuda.launches
    got = block_epilogue_cuda(*args, **extra)
    torch.cuda.synchronize()
    assert block_epilogue_cuda.launches == before + 1
    plain = block_epilogue_plain(*args, **extra)
    exact = _block_float64(*args, **extra)
    err, plain_err = _rel(got, exact), _rel(plain, exact)
    assert torch.isfinite(got).all()
    assert err <= 1.5 * plain_err, (err, plain_err)
    assert torch.equal(got, plain), _rel(got, plain)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_blocks_kernel_is_the_composition(cuda, kind):
    """An EncoderBlock or a gated DecoderBlock on the card (float32,
    gradients off) launches K6 once and gives to the bit what its old
    composition gives (the encoder's conv1 with its bias, the gate as a
    product, GroupNorm, GLU)."""
    from acousticswarms_speech_tpu_torch.models.modules import (
        DecoderBlock,
        EncoderBlock,
    )
    from acousticswarms_speech_tpu_torch.ops.block_epilogue import \
        block_epilogue_cuda

    torch.manual_seed(5)
    if kind == "encoder":
        block = EncoderBlock(128, 256, 7, 4, 3, 7,
                             use_window_embedding=True).to(cuda)
        args = (torch.randn(17, 128, 18048, device=cuda),)
    else:
        block = DecoderBlock(256, 128, 4, 7, 3, 7,
                             use_window_embedding=True).to(cuda)
        args = (torch.randn(17, 256, 4512, device=cuda),
                torch.randn(17, 256, 4512, device=cuda))
    w = torch.tensor([[0.0, 1.0]], device=cuda).expand(17, 2).contiguous()
    with torch.no_grad():
        block.norm1.weight.normal_(1, 0.3)
        block.norm1.bias.normal_(0, 0.3)
        before = block_epilogue_cuda.launches
        got = block(*args, w)
        assert block_epilogue_cuda.launches == before + 1
        g = block.embed1(w[:, :, None])
        if kind == "encoder":
            y = block.norm1(block.conv1(g * block.res(args[0])))
            a, b = y.chunk(2, dim=1)
            want = a * torch.sigmoid(b)
        else:
            y = block.norm1(g * block.upsample_conv(args[0] + args[1]))
            a, b = y.chunk(2, dim=1)
            want = block.res(a * torch.sigmoid(b))
        assert torch.equal(got, want), _rel(got, want)


def test_block_epilogue_unaligned_input(cuda):
    """A contiguous view 4 bytes past an allocation's start takes the
    scalar path and still gives the plain version's bits."""
    from acousticswarms_speech_tpu_torch.ops.block_epilogue import (
        block_epilogue_cuda,
        block_epilogue_plain,
    )

    (e, w, b, eps), extra = _block_inputs("gate", 3, 256, 4512, cuda, 12)
    es = torch.empty(e.numel() + 1, device=cuda)[1:].view_as(e).copy_(e)
    assert es.is_contiguous() and es.data_ptr() % 16 != 0
    got = block_epilogue_cuda(es, w, b, eps, **extra)
    assert torch.equal(got, block_epilogue_plain(e, w, b, eps, **extra))


def test_block_epilogue_rejects_bad_inputs(cuda):
    from acousticswarms_speech_tpu_torch.ops.block_epilogue import \
        block_epilogue_cuda

    (e, w, b, eps), extra = _block_inputs("gate", 2, 64, 256, cuda, 3)
    before = block_epilogue_cuda.launches
    with pytest.raises(TypeError):
        block_epilogue_cuda(e.double(), w, b, eps)
    with pytest.raises(ValueError):  # devices
        block_epilogue_cuda(e, w.cpu(), b, eps)
    with pytest.raises(ValueError):
        block_epilogue_cuda(e, w, b, eps, gate=extra["gate"].cpu())
    with pytest.raises(ValueError):  # shapes
        block_epilogue_cuda(e[:, :63].contiguous(), w, b, eps)
    with pytest.raises(ValueError):
        block_epilogue_cuda(e, w, b, eps, gate=extra["gate"][:1].contiguous())
    with pytest.raises(ValueError):  # strides
        block_epilogue_cuda(e.transpose(1, 2).contiguous().transpose(1, 2),
                            w, b, eps)
    assert block_epilogue_cuda.launches == before


def test_block_epilogue_counts_launches_and_dispatch(cuda):
    """One SpotNet chunk launches K6 once for each of its 10 blocks and one
    SepNet forward 8 times, each launch counted on the wrapper; with
    gradients on, or in bfloat16, a block runs the plain composition."""
    from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet, init_model
    from acousticswarms_speech_tpu_torch.models.modules import EncoderBlock
    from acousticswarms_speech_tpu_torch.ops.block_epilogue import \
        block_epilogue_cuda

    def launches(fn):
        before = block_epilogue_cuda.launches
        fn()
        torch.cuda.synchronize()
        return block_epilogue_cuda.launches - before

    spot = init_model(SpotNet().eval(), seed=0).to(cuda)
    x = torch.randn(4, 7, 72000, device=cuda)
    w = torch.tensor([[0.0, 1.0]], device=cuda).expand(4, 2)
    with torch.no_grad():
        assert launches(lambda: spot(x, w)) == 10
    sep = init_model(SepNet().eval(), seed=0).to(cuda)
    mix = torch.randn(1, 3 * 7, 72000, device=cuda)
    with torch.no_grad():
        assert launches(lambda: sep(mix, torch.tensor([3], device=cuda))) == 8

    block = EncoderBlock(64, 64, 7, 2, 1, 7).to(cuda)
    h = torch.randn(2, 64, 4096, device=cuda)
    with torch.enable_grad():
        assert launches(lambda: block(h).sum().backward()) == 0
    with torch.no_grad():
        assert launches(lambda: block.to(torch.bfloat16)(h.bfloat16())) == 0
