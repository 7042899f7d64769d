"""Training losses: L1, composite L1+SNR, masked SI-SDR (JAX:
training/losses.py).

Counterpart of reference sep/training/losses.py and the loss registry in
base_network.py:12-30.  The SNR/SI-SDR terms follow asteroid's
`SingleSrcNegSDR` (zero mean, eps-stabilized, negated dB).  The reference's
data-dependent `if any(mask)` branches are masked means, as in the JAX
package.

Each loss takes an optional `count_gt`: the targets of the whole batch
when `output`/`gt` are one rank's rows of it (parallel/mesh.py's
data-parallel step).  Its means then divide by the whole batch's counts,
so the loss is that rank's share of the whole batch's loss, and the
shares sum to it.
"""
from __future__ import annotations

import torch

EPS = 1e-8


def neg_sdr(est: torch.Tensor, target: torch.Tensor, sdr_type: str = "snr",
            zero_mean: bool = True) -> torch.Tensor:
    """Negative SDR per item; est/target: (N, T) -> (N,).

    sdr_type 'snr': plain SNR; 'sisdr': scale-invariant projection.
    """
    if zero_mean:
        est = est - est.mean(dim=1, keepdim=True)
        target = target - target.mean(dim=1, keepdim=True)
    if sdr_type == "sisdr":
        dot = torch.sum(est * target, dim=1, keepdim=True)
        s_energy = torch.sum(target ** 2, dim=1, keepdim=True) + EPS
        s_target = dot * target / s_energy
    else:
        s_target = target
    e_noise = est - s_target
    ratio = (torch.sum(s_target ** 2, dim=1) + EPS) / (
        torch.sum(e_noise ** 2, dim=1) + EPS
    )
    return -10.0 * torch.log10(ratio)


def l1_loss(output: torch.Tensor, gt: torch.Tensor,
            count_gt: torch.Tensor | None = None) -> torch.Tensor:
    if count_gt is None:
        return torch.mean(torch.abs(output - gt))
    return torch.sum(torch.abs(output - gt)) / count_gt.numel()


def composite_loss(output: torch.Tensor, gt: torch.Tensor, r: float = 0.0,
                   neg_scale: float = 1.0,
                   count_gt: torch.Tensor | None = None) -> torch.Tensor:
    """CompositeLoss (losses.py:6-46): all-zero (negative) targets get L1
    only, scaled by `neg_scale`; positive targets get r*L1 + (1-r)*SNR."""
    gt2 = gt[:, 0]
    out2 = output[:, 0]
    neg_mask = torch.amax(torch.abs(gt2), dim=1) == 0  # (N,)

    l1_per = torch.mean(torch.abs(out2 - gt2), dim=1)  # (N,)
    snr_per = neg_sdr(out2, gt2, "snr")

    zero = torch.zeros((), dtype=l1_per.dtype, device=l1_per.device)
    count_neg = (neg_mask if count_gt is None
                 else torch.amax(torch.abs(count_gt[:, 0]), dim=1) == 0)
    n_neg = count_neg.sum()
    n_pos = (~count_neg).sum()
    loss = torch.where(
        n_neg > 0,
        torch.where(neg_mask, l1_per, zero).sum() / n_neg.clamp(min=1)
        * neg_scale,
        zero,
    )
    pos_term = (
        torch.where(~neg_mask, l1_per, zero).sum() / n_pos.clamp(min=1) * r
        + torch.where(~neg_mask, snr_per, zero).sum() / n_pos.clamp(min=1)
        * (1 - r)
    )
    return loss + torch.where(n_pos > 0, pos_term, zero)


def sisdr_loss(output: torch.Tensor, gt: torch.Tensor,
               count_gt: torch.Tensor | None = None) -> torch.Tensor:
    """SISDRLoss (losses.py:48-66): mean negative SI-SDR over non-silent
    targets."""
    gt2 = gt[:, 0]
    out2 = output[:, 0]
    pos_mask = torch.amax(torch.abs(gt2), dim=1) > 0
    per = neg_sdr(out2, gt2, "sisdr")
    count_pos = (pos_mask if count_gt is None
                 else torch.amax(torch.abs(count_gt[:, 0]), dim=1) > 0)
    n = count_pos.sum().clamp(min=1)
    return torch.where(pos_mask, per, torch.zeros_like(per)).sum() / n


def get_loss_fn(name: str):
    """Loss registry matching BaseNetwork.set_loss (base_network.py:12-30)."""
    if name == "l1":
        return l1_loss
    if name == "snr":
        return lambda o, g, **kw: composite_loss(o, g, r=0.0, neg_scale=1.0,
                                                 **kw)
    if name == "snr_w_scaled_neg":
        return lambda o, g, **kw: composite_loss(o, g, r=0.0,
                                                 neg_scale=500.0, **kw)
    if name == "fused":
        return lambda o, g, **kw: composite_loss(o, g, r=0.05, neg_scale=1.0,
                                                 **kw)
    if name == "sisdr":
        return sisdr_loss
    raise ValueError(f"Unknown loss '{name}'")
