"""Parity of the port's tensor ops (acousticswarms_speech_tpu_torch.ops,
models.common) with the JAX package's, on the CPU.  Inputs come from numpy
seeds and go to both packages as numpy arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acousticswarms_speech_tpu.constants import FREQ_BINS, FS, N_FFT
from acousticswarms_speech_tpu.models import common as jax_common
from acousticswarms_speech_tpu.ops import power as jax_power
from acousticswarms_speech_tpu.ops import shift as jax_shift
from acousticswarms_speech_tpu.ops import similarity as jax_similarity
from acousticswarms_speech_tpu.ops import srp as jax_srp
from acousticswarms_speech_tpu.ops.pallas_shift import pallas_roll_channels_batch
from acousticswarms_speech_tpu_torch.models import common
from acousticswarms_speech_tpu_torch.ops import power, shift, similarity, srp

T_ROLL = 1024


def _shift_cases(rng, T, M=7):
    """(name, (B, M) int32 shifts): negative, zero, near +-T and random.
    The fixed rows repeat their 7-mic pattern across M channels."""
    def row(pattern):
        return np.resize(np.array(pattern), M)

    return {
        "random": rng.integers(-90, 90, (3, M)),
        "zero": np.zeros((2, M)),
        "negative": -rng.integers(1, T, (2, M)),
        "near_plus_T": np.array([row([T - 1, T - 2, 1, 0, T - 1, 2, T - 3])] * 2),
        "near_minus_T": np.array([row([-(T - 1), -(T - 2), -1, 0, -(T - 1), -5,
                                       -(T - 3)])] * 2),
        "edges": np.array([row([-(T - 1), -5, 0, 3, T - 1, 7, -7])]),
    }


def _cases_by_mics(cases):
    """(case, M) for M in 7 and 10; the 7-mic cases keep their plain ids."""
    return ([pytest.param(c, 7, id=c) for c in cases]
            + [pytest.param(c, 10, id=f"{c}-M10") for c in cases])


@pytest.mark.parametrize("case,M", _cases_by_mics(
    ["random", "zero", "negative", "near_plus_T", "near_minus_T", "edges"]))
def test_roll_plain_matches_jax_and_pallas(case, M):
    """roll_channels_batch_plain equals the JAX gather roll and the Pallas
    kernel in interpret mode exactly (a copy has no rounding), at 7 and 10
    mics."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(M, T_ROLL)).astype(np.float32)
    s = _shift_cases(rng, T_ROLL, M)[case].astype(np.int32)
    got = shift.roll_channels_batch_plain(torch.from_numpy(x),
                                          torch.from_numpy(s)).numpy()
    want = np.asarray(jax_shift.roll_channels_batch(jnp.asarray(x),
                                                    jnp.asarray(s)))
    pallas = np.asarray(pallas_roll_channels_batch(
        jnp.asarray(x), jnp.asarray(s), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    # the dispatcher takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        shift.roll_channels_batch(torch.from_numpy(x), torch.from_numpy(s)),
        got)


def test_roll_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version itself."""
    from acousticswarms_speech_tpu_torch.ops.roll_kernel import (
        roll_channels_batch_cuda,
    )

    with pytest.raises(ValueError):
        roll_channels_batch_cuda(torch.zeros(7, 16),
                                 torch.zeros(2, 7, dtype=torch.int32))


@pytest.mark.parametrize("case,M", _cases_by_mics(
    ["random", "near_plus_T", "near_minus_T", "edges"]))
def test_roll_zero_fill_matches_jax(case, M):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(M, T_ROLL)).astype(np.float32)
    s = _shift_cases(rng, T_ROLL, M)[case].astype(np.int32)
    got = shift.roll_zero_fill_batch(torch.from_numpy(x),
                                     torch.from_numpy(s)).numpy()
    want = np.asarray(jax_shift.roll_zero_fill_batch(jnp.asarray(x),
                                                     jnp.asarray(s)))
    np.testing.assert_array_equal(got, want)


def test_normalize_input_matches_jax():
    """16-bit rounding, mean over mics, Bessel std: float32 reductions in
    another order, so agreement to a few ulps of the unit-variance output."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 7, 5000)) * 0.05).astype(np.float32)
    got = common.normalize_input(torch.from_numpy(x))
    want = jax_common.normalize_input(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    back = common.unnormalize_input(*got)
    np.testing.assert_allclose(back.numpy(), np.round(x * 2 ** 15) / 2 ** 15,
                               atol=1e-6)


def test_candidate_powers_matches_jax():
    """Total power and max 12000-sample windowed RMS.  Both use a float32
    cumulative sum; tolerance 1e-4 relative covers its summation order."""
    rng = np.random.default_rng(2)
    env = (np.sin(np.linspace(0, 9, 30000)) > 0.3)
    x = (rng.normal(size=(5, 30000)) * env * 0.1 + 0.01).astype(np.float32)
    got = power.candidate_powers(torch.from_numpy(x))
    want = jax_power.candidate_powers(jnp.asarray(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)


def test_sisdr_matrix_matches_jax():
    """Gram-matrix SI-SDR in dB; float32 Gram sums in another order, so
    0.01 dB (the clustering thresholds are whole dB)."""
    rng = np.random.default_rng(4)
    base = rng.normal(size=(1, 8000))
    x = base + rng.normal(size=(6, 8000)) * np.linspace(0.1, 3, 6)[:, None]
    x = (x - x.mean(axis=1, keepdims=True)).astype(np.float32)
    got = similarity.sisdr_matrix(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_similarity.sisdr_matrix(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_steering_table_matches_jax():
    rng = np.random.default_rng(5)
    grids = np.column_stack([rng.uniform(1, 6, 50), rng.uniform(0, 5, 50),
                             rng.uniform(0.1, 0.6, 50)])
    mic = np.column_stack([rng.uniform(3, 4, 7), rng.uniform(0.5, 1.5, 7),
                           np.full(7, 0.02)])
    got = srp.build_steering_table(grids, mic, FREQ_BINS, FS, N_FFT)
    want = jax_srp.build_steering_table(grids, mic, FREQ_BINS, FS, N_FFT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("T", [24000, 72000])
def test_srp_map_matches_jax(T):
    """torch.fft in place of the JAX matmul DFT: the maps agree to 1e-4 of
    their peak (float32 DFTs summed differently)."""
    rng = np.random.default_rng(6)
    grids = np.column_stack([rng.uniform(1, 6, 300), rng.uniform(0, 5, 300),
                             rng.uniform(0.1, 0.6, 300)])
    mic = np.array([[3.0, 1.0, 0.02], [3.5, 1.3, 0.02], [3.5, 0.7, 0.02],
                    [3.7, 1.0, 0.02], [3.3, 1.5, 0.02], [3.3, 0.5, 0.02],
                    [3.6, 1.15, 0.02]])
    src = rng.normal(size=T + 200)
    sig = np.stack([src[100 + d : 100 + d + T]
                    for d in [0, 12, -9, 20, 5, -15, 14]])
    sig = (sig + 0.3 * rng.normal(size=sig.shape)).astype(np.float32)
    window = jax_srp.srp_window_size(T)
    want = np.asarray(jax_srp.SrpMapComputer(grids, mic, FREQ_BINS, FS,
                                             N_FFT)(sig, window))
    got = srp.SrpMapComputer(grids, mic, FREQ_BINS, FS, N_FFT,
                             device="cpu")(sig, window).numpy()
    assert got.shape == want.shape == (300,)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    assert np.argmax(got) == np.argmax(want)
