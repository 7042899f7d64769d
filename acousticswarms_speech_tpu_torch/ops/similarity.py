"""Pairwise SI-SDR from the Gram matrix (JAX: ops/similarity.py).

For zero-mean signals, with G = X X^T:
    sisdr(est i, ref j) = 10 log10((G_ij^2 / G_jj) / (G_ii - G_ij^2 / G_jj)).
"""
from __future__ import annotations

import torch

EPS = 1e-8


def sisdr_matrix(x: torch.Tensor) -> torch.Tensor:
    """x: (K, T) zero-mean -> (K, K), [i, j] = si_sdr(x[i], reference x[j])."""
    xf = x.float()
    gram = xf @ xf.T
    diag = torch.diagonal(gram)
    s_target = gram ** 2 / torch.clamp(diag[None, :], min=EPS)
    e_res = torch.clamp(diag[:, None] - s_target, min=0.0) + EPS
    return 10.0 * torch.log10(torch.clamp(s_target, min=1e-30) / e_res)
