"""The Inception Score (counterpart of `cpcsv_tpu/evaluation/inception_score.py`;
reference `fid/inception_score.py:10-68`): IS = exp(E_x KL(p(y|x) || p(y)))
over `splits` chunks of the images, from InceptionV3's class probabilities
(`inception.make_inception_classifier`). Without pretrained weights the
classifier is random and so is the score; the classifier's `random_init`
says so."""

from __future__ import annotations

import numpy as np

from cpcsv_tpu_torch.evaluation.features import iter_batches


def inception_score_from_probs(probs: np.ndarray, splits: int = 10):
    """(mean, std) of the score over `splits` equal chunks of `probs`
    (N, classes), softmax outputs; the remainder of N // splits is left out."""
    N = probs.shape[0]
    if N < splits:
        raise ValueError(
            f"inception score needs at least splits={splits} samples, got {N} (lower "
            "`splits` or provide more images; a mean over zero chunks would be NaN)")
    scores = []
    for k in range(splits):
        part = probs[k * (N // splits):(k + 1) * (N // splits)]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def inception_score(dataset, classifier, batch_size: int = 32, splits: int = 10,
                    normalize: bool = False):
    """The score of every image of `dataset` (items (H, W, 3)), the last batch
    partial; `classifier` maps a batch to logits (numpy in and out);
    `normalize` shifts [-1, 1] images to the classifier's [0, 1]."""
    probs = []
    for batch in iter_batches(dataset, batch_size, drop_last=False):
        x = batch.astype(np.float32)
        if normalize:
            x = (x + 1.0) / 2.0
        logits = np.asarray(classifier(x))
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs.append(e / e.sum(axis=1, keepdims=True))
    return inception_score_from_probs(np.concatenate(probs, axis=0), splits)
