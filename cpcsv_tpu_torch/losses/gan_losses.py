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

In a process group (`parallel/`) every function takes `rows`, this rank's
`mesh.Rows` of the global batch, and returns this rank's share of the
one-process value: its rows' sum over the global count, so that the ranks'
losses add up to the one-process loss and their gradients to its gradient.
The share is computed as the local mean times local/total (`batch_mean`): a group
of one rank then gives the one-process bits. A rank with no rows of a term
(the last rank's wrong pairs at one row a rank) gives the term as the sum of
its empty logits: zero, and still on the autograd graph, so that its
backward reaches the BN collectives of the rows it did not have. An
accuracy's share is the rank's hits over the global count of positive
labels (one all-reduce). Without `rows` nothing changes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cpcsv_tpu_torch.parallel.mesh import Rows, all_reduce_sum_


def batch_mean(x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
    """x.mean(), x's leading axis being the batch's rows; with `rows`, this
    rank's share of the mean over the global rows."""
    if rows is None or rows.local == rows.total:
        return x.mean()
    if rows.local == 0:
        return x.sum()  # zero, kept on the graph
    return x.mean() * (rows.local / rows.total)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    rows: Optional[Rows] = None) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy, max(x, 0) − x·y + log1p(e^−|x|)."""
    x, y = logits.float(), targets.float()
    return batch_mean(torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs())), rows)


def multilabel_soft_margin(logits: torch.Tensor, targets: torch.Tensor,
                           rows: Optional[Rows] = None) -> torch.Tensor:
    """torch's MultiLabelSoftMarginLoss: the batch mean of the per-class mean
    of −[y·log σ(x) + (1 − y)·log σ(−x)]."""
    x, y = logits.float(), targets.float()
    per = y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x)
    return -batch_mean(per.mean(dim=-1), rows)


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
    """−0.5·mean(1 + logvar − mu² − exp(logvar))."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * batch_mean(1.0 + logvar - mu * mu - torch.exp(logvar), rows)


def multi_label_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                         rows: Optional[Rows] = None) -> torch.Tensor:
    """The fraction of positive labels whose sigmoid score is >= 0.5
    (reference `get_multi_acc`, `miscc/utils.py:313-321`)."""
    correct = ((targets == 1) & (torch.sigmoid(logits.float()) >= 0.5)).sum()
    positives = targets.float().sum()
    if rows is not None:
        positives = all_reduce_sum_(positives.reshape(1)).reshape(())
    return correct / torch.clamp(positives, min=1.0)


def infonce_loss(pair_logits: torch.Tensor, temperature: float = 1.0,
                 rows: Optional[Rows] = None) -> torch.Tensor:
    """Batch-wise InfoNCE over pair_logits[i, j] = D(features_i, condition_j),
    the diagonal matched: −mean_i log softmax_j(pair_logits[i] / τ)[i]. With
    `rows`, pair_logits is this rank's (local, total) block, its matched
    pairs at [k, rows.lo + k]."""
    log_probs = torch.log_softmax(pair_logits.float() / temperature, dim=-1)
    return -batch_mean(torch.diagonal(log_probs, offset=rows.lo if rows else 0), rows)


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
    rows: Optional[Rows] = None,
    wrong_rows: Optional[Rows] = None,
) -> DLossOut:
    """`wrong_logits` is ignored (pass None) where `pair_logits` is given.
    `rows` are the real and fake logits', `wrong_rows` the wrong pairs'
    (`mesh.wrong_pair_rows`; a global batch of one has none)."""
    zero = real_logits.new_zeros((), dtype=torch.float32)
    err_real = bce_with_logits(real_logits, torch.ones_like(real_logits), rows)
    if pair_logits is not None:
        err_wrong = infonce_loss(pair_logits, infonce_temperature, rows)
    elif wrong_logits.numel() > 0 or (wrong_rows is not None and wrong_rows.total > 0):
        err_wrong = bce_with_logits(wrong_logits, torch.zeros_like(wrong_logits), wrong_rows)
    else:  # no wrong pair at batch 1 (see the discriminators' d_phase)
        err_wrong = zero
    err_fake = bce_with_logits(fake_logits, torch.zeros_like(fake_logits), rows)
    total = err_real + 0.5 * (err_fake + err_wrong)
    acc = zero
    if cate_logits_real is not None:
        total = total + multilabel_soft_margin(cate_logits_real, cate_labels, rows)
        acc = multi_label_accuracy(cate_logits_real, cate_labels, rows)
    cons = zero
    if order_logits is not None:
        cons = bce_with_logits(order_logits.reshape(-1), order_labels.reshape(-1), rows)
        total = total + consistency_ratio * cons
    return DLossOut(total, err_real, err_wrong, err_fake, acc, cons)


def generator_loss(
    fake_logits: torch.Tensor,
    cate_logits_fake: Optional[torch.Tensor],
    cate_labels: Optional[torch.Tensor],
    consistency_fake: Optional[torch.Tensor] = None,
    consistency_real: Optional[torch.Tensor] = None,
    consistency_ratio: float = 1.0,
    rows: Optional[Rows] = None,
) -> GLossOut:
    zero = fake_logits.new_zeros((), dtype=torch.float32)
    total = bce_with_logits(fake_logits, torch.ones_like(fake_logits), rows)
    acc = zero
    if cate_logits_fake is not None:
        total = total + multilabel_soft_margin(cate_logits_fake, cate_labels, rows)
        acc = multi_label_accuracy(cate_logits_fake, cate_labels, rows)
    cons = zero
    if consistency_fake is not None:
        cons = batch_mean(torch.square(consistency_fake.float() - consistency_real.detach().float()),
                     rows)
        total = total + consistency_ratio * cons
    return GLossOut(total, acc, cons)
