"""GAN losses (counterpart of `cpcsv_tpu/losses/gan_losses.py`, the
reference's loss algebra, `miscc/utils.py:48-188`), in float32.

  * discriminator_loss: real-pair BCE vs 1, wrong-pair (shifted conditions)
    BCE vs 0, fake-pair BCE vs 0; total = real + 0.5·(fake + wrong), plus the
    multi-label soft margin of the real features' character head, plus
    CONSISTENCY_RATIO × the order BCE of the VideoEncoder on shuffled
    stories. With InfoNCE the (B, B) pair matrix's `infonce_loss` takes the
    wrong term's slot.
  * generator_loss: BCE(fake logits, 1) plus the character loss on the fake
    features, plus CONSISTENCY_RATIO × MSE(VideoEncoder(fake),
    VideoEncoder(real)), the real side detached.
  * kl_loss: the CA-Net posterior's KL to N(0, 1).
  * infonce_loss: −mean_i log softmax_j(pair[i] / τ)[i], an extension of the
    JAX package (`gan_losses.py:infonce_loss`), not of the reference.

The heads return logits, so the BCE is taken with logits: the same number as
the reference's Sigmoid + BCELoss, without its overflow.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy, max(x, 0) − x·y + log1p(e^−|x|)."""
    x, y = logits.float(), targets.float()
    return (torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()


def multilabel_soft_margin(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch's MultiLabelSoftMarginLoss: the batch mean of the per-class mean
    of −[y·log σ(x) + (1 − y)·log σ(−x)]."""
    x, y = logits.float(), targets.float()
    per = y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x)
    return -per.mean(dim=-1).mean()


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """−0.5·mean(1 + logvar − mu² − exp(logvar))."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar)).mean()


def multi_label_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The fraction of positive labels whose sigmoid score is >= 0.5
    (reference `get_multi_acc`, `miscc/utils.py:313-321`)."""
    correct = ((targets == 1) & (torch.sigmoid(logits.float()) >= 0.5)).sum()
    return correct / torch.clamp(targets.float().sum(), min=1.0)


def infonce_loss(pair_logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Batch-wise InfoNCE over pair_logits[i, j] = D(features_i, condition_j),
    the diagonal matched: −mean_i log softmax_j(pair_logits[i] / τ)[i]."""
    log_probs = torch.log_softmax(pair_logits.float() / temperature, dim=-1)
    return -torch.diagonal(log_probs).mean()


class DLossOut(NamedTuple):
    total: torch.Tensor
    real: torch.Tensor
    wrong: torch.Tensor
    fake: torch.Tensor
    accuracy: torch.Tensor
    consistency: torch.Tensor


class GLossOut(NamedTuple):
    total: torch.Tensor
    accuracy: torch.Tensor
    consistency: torch.Tensor


def discriminator_loss(
    real_logits: torch.Tensor,
    wrong_logits: torch.Tensor,
    fake_logits: torch.Tensor,
    cate_logits_real: Optional[torch.Tensor],
    cate_labels: Optional[torch.Tensor],
    order_logits: Optional[torch.Tensor] = None,
    order_labels: Optional[torch.Tensor] = None,
    consistency_ratio: float = 1.0,
    pair_logits: Optional[torch.Tensor] = None,
    infonce_temperature: float = 1.0,
) -> DLossOut:
    """`wrong_logits` is ignored (pass None) where `pair_logits` is given."""
    zero = real_logits.new_zeros((), dtype=torch.float32)
    err_real = bce_with_logits(real_logits, torch.ones_like(real_logits))
    if pair_logits is not None:
        err_wrong = infonce_loss(pair_logits, infonce_temperature)
    elif wrong_logits.numel() > 0:
        err_wrong = bce_with_logits(wrong_logits, torch.zeros_like(wrong_logits))
    else:  # no wrong pair at batch 1 (see the discriminators' d_phase)
        err_wrong = zero
    err_fake = bce_with_logits(fake_logits, torch.zeros_like(fake_logits))
    total = err_real + 0.5 * (err_fake + err_wrong)
    acc = zero
    if cate_logits_real is not None:
        total = total + multilabel_soft_margin(cate_logits_real, cate_labels)
        acc = multi_label_accuracy(cate_logits_real, cate_labels)
    cons = zero
    if order_logits is not None:
        cons = bce_with_logits(order_logits.reshape(-1), order_labels.reshape(-1))
        total = total + consistency_ratio * cons
    return DLossOut(total, err_real, err_wrong, err_fake, acc, cons)


def generator_loss(
    fake_logits: torch.Tensor,
    cate_logits_fake: Optional[torch.Tensor],
    cate_labels: Optional[torch.Tensor],
    consistency_fake: Optional[torch.Tensor] = None,
    consistency_real: Optional[torch.Tensor] = None,
    consistency_ratio: float = 1.0,
) -> GLossOut:
    zero = fake_logits.new_zeros((), dtype=torch.float32)
    total = bce_with_logits(fake_logits, torch.ones_like(fake_logits))
    acc = zero
    if cate_logits_fake is not None:
        total = total + multilabel_soft_margin(cate_logits_fake, cate_labels)
        acc = multi_label_accuracy(cate_logits_fake, cate_labels)
    cons = zero
    if consistency_fake is not None:
        cons = torch.mean(torch.square(consistency_fake.float()
                                       - consistency_real.detach().float()))
        total = total + consistency_ratio * cons
    return GLossOut(total, acc, cons)
