"""Language-model loss helpers (the LSTM subset of ``repro.models.lm``)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy", "mask_padded_vocab"]


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Set the padded vocab tail of the logits to -1e30."""
    if logits.shape[-1] == vocab:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota >= vocab, torch.full((), -1e30, dtype=logits.dtype,
                                                 device=logits.device), logits)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross entropy with f32 reductions: a max-shifted
    log-sum-exp (the shift carries no gradient) minus the label's logit.
    The reference picks that logit by a one-hot sum; a gather gives the
    same value and gradient."""
    lf = logits.to(torch.float32)
    m = lf.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mk = mask.to(torch.float32)
    return (nll * mk).sum() / torch.clamp(mk.sum(), min=1.0)
