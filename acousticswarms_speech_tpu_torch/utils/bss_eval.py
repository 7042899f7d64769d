"""BSS-Eval source-separation metrics (SDR / SIR / SAR).

Host NumPy, copied from the JAX package's `utils/bss_eval.py` for the PyTorch port
(the port imports nothing of that package).

mir_eval-free implementation of the classic Vincent et al. (2006) BSS-Eval
decomposition used by the reference's evaluation
(reference sep/eval/get_items.py:46-52): each estimate is decomposed by
least-squares projection onto 512-tap filtered versions of the true sources,

    s_target = P_{s_j}(est),  e_interf = P_{all s}(est) - s_target,
    e_artif  = est - P_{all s}(est)

with SDR = 10log10 ||s_target||^2 / ||e_interf + e_artif||^2, etc.
Projections solve the block-Toeplitz normal equations built from FFT-based
correlations, exactly as in the published algorithm.
"""
from __future__ import annotations

import itertools

import numpy as np
from scipy.linalg import solve, toeplitz

FLEN = 512


def _project(reference_sources: np.ndarray, estimated_source: np.ndarray,
             flen: int = FLEN) -> np.ndarray:
    """Least-squares projection of `estimated_source` (T,) onto the subspace
    spanned by delayed (0..flen-1) versions of each row of
    `reference_sources` (nsrc, T)."""
    nsrc, T = reference_sources.shape
    n_fft = int(2 ** np.ceil(np.log2(T + flen - 1)))
    sf = np.fft.rfft(reference_sources, n=n_fft, axis=1)
    ef = np.fft.rfft(estimated_source, n=n_fft)

    # Autocorrelation blocks G[i, j] (flen x flen Toeplitz each)
    G = np.zeros((nsrc * flen, nsrc * flen))
    for i in range(nsrc):
        for j in range(i, nsrc):
            ssf = np.fft.irfft(sf[i] * np.conj(sf[j]), n=n_fft)
            ss = toeplitz(
                np.hstack((ssf[0], ssf[-1 : -flen : -1])), r=ssf[:flen]
            )
            G[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = ss
            G[j * flen:(j + 1) * flen, i * flen:(i + 1) * flen] = ss.T

    # Cross-correlation vector D
    D = np.zeros(nsrc * flen)
    for i in range(nsrc):
        ssef = np.fft.irfft(sf[i] * np.conj(ef), n=n_fft)
        D[i * flen:(i + 1) * flen] = np.hstack((ssef[0], ssef[-1 : -flen : -1]))

    try:
        C = solve(G, D, assume_a="sym").reshape(nsrc, flen)
    except np.linalg.LinAlgError:
        C = np.linalg.lstsq(G, D, rcond=None)[0].reshape(nsrc, flen)

    # Filter and sum
    sproj = np.zeros(T + flen - 1)
    for i in range(nsrc):
        sproj += np.convolve(C[i], reference_sources[i])[: T + flen - 1]
    return sproj


def _bss_decomp(reference_sources: np.ndarray, estimated_source: np.ndarray,
                j: int, flen: int = FLEN):
    T = estimated_source.shape[0]
    padded_est = np.concatenate([estimated_source, np.zeros(flen - 1)])
    s_target = _project(reference_sources[j: j + 1], estimated_source, flen)
    P_all = _project(reference_sources, estimated_source, flen)
    e_interf = P_all - s_target
    e_artif = padded_est - P_all
    return s_target, e_interf, e_artif


def _safe_db(num: float, den: float) -> float:
    return 10 * np.log10((num + 1e-12) / (den + 1e-12))


def bss_eval_sources(reference_sources: np.ndarray,
                     estimated_sources: np.ndarray,
                     compute_permutation: bool = True):
    """reference_sources, estimated_sources: (nsrc, T).

    Returns (sdr, sir, sar, perm) like mir_eval.separation.bss_eval_sources.
    With compute_permutation=False the identity pairing is scored.
    """
    ref = np.atleast_2d(np.asarray(reference_sources, dtype=np.float64))
    est = np.atleast_2d(np.asarray(estimated_sources, dtype=np.float64))
    nsrc = est.shape[0]

    def score(j_est: int, j_ref: int):
        s_target, e_interf, e_artif = _bss_decomp(ref, est[j_est], j_ref)
        st = np.sum(s_target ** 2)
        sdr = _safe_db(st, np.sum((e_interf + e_artif) ** 2))
        sir = _safe_db(st, np.sum(e_interf ** 2))
        sar = _safe_db(np.sum((s_target + e_interf) ** 2),
                       np.sum(e_artif ** 2))
        return sdr, sir, sar

    if not compute_permutation:
        results = [score(j, j) for j in range(nsrc)]
        sdr, sir, sar = map(np.array, zip(*results))
        return sdr, sir, sar, np.arange(nsrc)

    table = np.array([[score(je, jr) for jr in range(ref.shape[0])]
                      for je in range(nsrc)])  # (est, ref, 3)
    best_perm, best_sdr = None, -np.inf
    for perm in itertools.permutations(range(ref.shape[0]), nsrc):
        mean_sdr = np.mean([table[je, jr, 0] for je, jr in enumerate(perm)])
        if mean_sdr > best_sdr:
            best_sdr, best_perm = mean_sdr, perm
    perm = np.array(best_perm)
    sdr = np.array([table[je, jr, 0] for je, jr in enumerate(perm)])
    sir = np.array([table[je, jr, 1] for je, jr in enumerate(perm)])
    sar = np.array([table[je, jr, 2] for je, jr in enumerate(perm)])
    return sdr, sir, sar, perm
