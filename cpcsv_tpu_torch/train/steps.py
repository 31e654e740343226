"""The alternating D step and G step (counterpart of
`cpcsv_tpu/train/steps.py:make_train_steps`; reference `trainer.py:248-416`).

  D step: the generator samples stories and images in train mode without
    gradients (its BN running statistics update, `_sample_all`), then the
    seg, image and story discriminators each take one Adam step on
    real + 0.5·(fake + wrong) BCE (+ the character loss), in that order.
  G step: the generator samples again with fresh noise, the conditions are
    detached, the discriminators run `g_phase` in train mode (their BN and SN
    state changes, their parameters do not), and only the generator steps on
      im_G + KL·im_KL + SEGMENT_RATIO·se_G + IMAGE_RATIO·st_G + KL·st_KL
        [+ RECONSTRUCT_LOSS·(video_latent + reconstruct), cascade only].
    The reference's `ratio` on the story/seg group is 1.0 (main_pororo.py).
    Cascade: video_latent (image_latent) is the sum of four MSEs between the
    story (image) call's two latent pyramids, (zmc_seg, h_seg1, h_seg2,
    h_seg3) and the re-encoder's (g1, g2, g3, g4), neither side detached;
    reconstruct is the mean of the seg autoencoder's MSE on the real masks
    and on the generated ones, in that order (each call updates the seg
    trunk's BN statistics). image_latent is logged but kept out of the total,
    as the reference does (trainer.py:370-413).

Batches are dicts in the JAX schema (`steps.py:100-106`), numpy arrays or
tensors, NHWC: st_batch images (B, T, 64, 64, 3), description (B, T, 356),
labels (B, T, 9); im_batch images (B, 64, 64, 3), description (B, 356),
labels (B, 9), content (B, T, >=356), images_seg (B, 64, 64, 1).

`rng` is a `torch.Generator` on the nets' device, from which each step draws
the story noise then the image noise (CA eps, motion-GRU h0, per-step noise
each, `StoryGenerator.draw_noise`), or those draws themselves as a pair
(st_noise, im_noise). Each step holds float32 itself (`device.float32_math`),
returns the state it updated in place and its metrics as 0-d tensors under
the JAX tag names, and leaves each stepped parameter's gradient in `.grad`.

At COMPUTE_DTYPE bfloat16 the nets compute in bfloat16 (`models/`), while the
batches enter as float32, every loss (the cascade MSEs included, as
`cpcsv_tpu/train/steps.py:_mse`) is taken in float32, and the parameters,
their gradients, the Adam moments and the BN running statistics stay
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.device import float32_math
from cpcsv_tpu_torch.losses.gan_losses import (
    discriminator_loss,
    generator_loss,
    kl_loss,
)
from cpcsv_tpu_torch.train.state import TrainState


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The array fields of a batch as float32 tensors on `device`."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in batch.items() if torch.is_tensor(v) or isinstance(v, np.ndarray)}


def build_conditions(st_batch, im_batch, c_mu, cim_mu):
    """st_mu = [c_mu | mean_t description | characters present] and
    im_mu = [description | labels | cim_mu] (reference trainer.py:303-308)."""
    characters = (st_batch["labels"].mean(dim=1) > 0).float()
    st_mu = torch.cat([c_mu, st_batch["description"].mean(dim=1), characters], dim=1)
    im_motion = torch.cat([im_batch["description"], im_batch["labels"]], dim=1)
    return st_mu, torch.cat([im_motion, cim_mu], dim=1)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a.float() - b.float()))


def _latent_loss(latents) -> torch.Tensor:
    (h1, h2, h3, h4), (g1, g2, g3, g4) = latents
    return _mse(g1, h1) + _mse(g2, h2) + _mse(g3, h3) + _mse(g4, h4)


def _sample_all(cfg: Config, net_g, rng, st_batch, im_batch):
    st_motion = torch.cat([st_batch["description"], st_batch["labels"]], dim=2)
    im_motion = torch.cat([im_batch["description"], im_batch["labels"]], dim=1)
    im_content = im_batch["content"][:, :, : cfg.TEXT.DIMENSION]
    if isinstance(rng, torch.Generator):
        st_noise = net_g.draw_noise(st_motion.shape[0], st_motion.shape[1], rng)
        im_noise = net_g.draw_noise(im_motion.shape[0], 1, rng)
    else:
        st_noise, im_noise = rng
    # the cascade reads the story call's mask and latents in the G step
    st_out = net_g.sample_videos(st_motion, st_batch["description"], seg=cfg.CASCADE_MODEL,
                                 noise=st_noise)
    im_out = net_g.sample_images(im_motion, im_content, seg=True, noise=im_noise)
    return st_out, im_out


def _step(net, opt, loss, lr: float) -> None:
    """One optimizer step of `net` on d loss / d params. Gradients go to this
    net only; a parameter the loss does not reach steps with a zero gradient,
    as optax's Adam does."""
    params = list(net.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = g if g is not None else torch.zeros_like(p)
    for group in opt.param_groups:
        group["lr"] = float(lr)
    opt.step()


def make_train_steps(cfg: Config):
    """(d_step, g_step), each (state, rng, st_batch, im_batch, lr) ->
    (state, metrics). Unlike the JAX package's, it takes no models: the nets
    are modules that live in the state."""
    seg_w, img_w, kl = cfg.SEGMENT_RATIO, cfg.IMAGE_RATIO, cfg.TRAIN.COEFF.KL

    def d_update(net, opt, real, fake, cond, cate_labels, lr):
        net.train()
        real_logits, wrong_logits, fake_logits, cate = net.d_phase(real, fake, cond)
        out = discriminator_loss(real_logits, wrong_logits, fake_logits, cate, cate_labels)
        _step(net, opt, out.total, lr)
        return out

    def d_step(state: TrainState, rng, st_batch, im_batch, lr_d):
        device = next(state.gen.parameters()).device
        st_batch, im_batch = batch_to_device(st_batch, device), batch_to_device(im_batch, device)
        with float32_math():
            state.gen.train()
            with torch.no_grad():
                st_out, im_out = _sample_all(cfg, state.gen, rng, st_batch, im_batch)
            st_mu, im_mu = build_conditions(st_batch, im_batch, st_out.c_mu, im_out.c_mu)
            labels = im_batch["labels"]
            se = d_update(state.d_se, state.opts["d_se"], im_batch["images_seg"], im_out.seg,
                          im_mu, labels, lr_d)
            im = d_update(state.d_im, state.opts["d_im"], im_batch["images"], im_out.image,
                          im_mu, labels, lr_d)
            st = d_update(state.d_st, state.opts["d_st"], st_batch["images"], st_out.image,
                          st_mu, None, lr_d)
        metrics = {
            "seg_D/loss": se.total, "seg_D/real": se.real, "seg_D/fake": se.fake,
            "Accuracy/se_D": se.accuracy,
            "img_D/loss": im.total, "img_D/real": im.real, "img_D/fake": im.fake,
            "Accuracy/im_D": im.accuracy,
            "st_D/loss": st.total, "st_D/real": st.real, "st_D/fake": st.fake,
            "st_D/order": st.consistency,
        }
        return state, {k: v.detach() for k, v in metrics.items()}

    def g_step(state: TrainState, rng, st_batch, im_batch, lr_g):
        device = next(state.gen.parameters()).device
        st_batch, im_batch = batch_to_device(st_batch, device), batch_to_device(im_batch, device)
        with float32_math():
            for net in state.nets().values():
                net.train()
            st_out, im_out = _sample_all(cfg, state.gen, rng, st_batch, im_batch)
            st_mu, im_mu = build_conditions(st_batch, im_batch, st_out.c_mu, im_out.c_mu)
            st_mu, im_mu = st_mu.detach(), im_mu.detach()  # the reference detaches them
            labels = im_batch["labels"]
            se_g = generator_loss(*state.d_se.g_phase(im_out.seg, im_mu), labels)
            im_g = generator_loss(*state.d_im.g_phase(im_out.image, im_mu), labels)
            st_g = generator_loss(state.d_st.g_phase(st_out.image, st_mu)[0], None, None)
            im_kl = kl_loss(im_out.c_mu, im_out.c_logvar)
            st_kl = kl_loss(st_out.c_mu, st_out.c_logvar)
            total = im_g.total + im_kl * kl + (se_g.total * seg_w + st_g.total * img_w + st_kl * kl)
            cascade = {}
            if cfg.CASCADE_MODEL:
                se_real = im_batch["images_seg"]
                recon_real = state.gen.train_autoencoder(se_real)
                recon_fake = state.gen.train_autoencoder(im_out.seg)
                cascade = {
                    "G/image_vae_loss": _latent_loss(im_out.latents),
                    "G/video_vae_loss": _latent_loss(st_out.latents),
                    "G/reconstruct_loss": (_mse(recon_real, se_real)
                                           + _mse(recon_fake, im_out.seg)) / 2.0,
                }
                total = total + (cascade["G/video_vae_loss"]
                                 + cascade["G/reconstruct_loss"]) * cfg.RECONSTRUCT_LOSS
            _step(state.gen, state.opts["gen"], total, lr_g)
        state.step += 1
        metrics = {
            **cascade,
            "G/im_KL": im_kl, "G/st_KL": st_kl, "G/KL": im_kl + st_kl,
            "G/consistency": st_g.consistency,
            "Accuracy/im_G": im_g.accuracy, "Accuracy/se_G": se_g.accuracy,
            "Accuracy/st_G": st_g.accuracy,
            "G/gan_loss": im_g.total + (img_w * st_g.total + se_g.total * seg_w),
            "G/loss": total,
        }
        return state, {k: v.detach() for k, v in metrics.items()}

    return d_step, g_step
