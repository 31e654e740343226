"""The alternating D step and G step (counterpart of
`cpcsv_tpu/train/steps.py:make_train_steps`; reference `trainer.py:248-416`),
and K such pairs a chunk (`make_scan_steps`, the counterpart of
`cpcsv_tpu/train/steps.py:make_scan_steps`).

  D step: the generator samples stories and images in train mode without
    gradients (its BN running statistics update, `_sample_all`), then the
    seg (with SEGMENT_LEARNING), image and story discriminators each take
    one Adam step on real + 0.5·(fake + wrong) BCE (+ the character loss),
    in that order. With USE_SEQ_CONSISTENCY the story D's loss adds
    CONSISTENCY_RATIO × the order BCE of its VideoEncoder on the batch's
    `shuffled` stories against `order_labels` (the trainer's host shuffle,
    `losses/shuffle.py`). With USE_INFONCE each D scores every (real
    feature, condition) pair in one head call, its diagonal is the real
    logits, and the pair matrix's InfoNCE at INFONCE_TEMPERATURE takes the
    wrong term's slot.
  G step: the generator samples again with fresh noise, the conditions are
    detached, the discriminators run `g_phase` in train mode (their BN and SN
    state changes, their parameters do not), and only the generator steps on
      im_G + KL·im_KL + SEGMENT_RATIO·se_G + IMAGE_RATIO·st_G + KL·st_KL
        [+ RECONSTRUCT_LOSS·(video_latent + reconstruct), cascade only],
    se_G being 0 without SEGMENT_LEARNING, and st_G with USE_SEQ_CONSISTENCY
    adding CONSISTENCY_RATIO × MSE(VideoEncoder(fake), VideoEncoder(real)),
    the encoder run on the real stories first.
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
labels (B, 9), content (B, T, >=356), images_seg (B, 64, 64, 1) (read with
SEGMENT_LEARNING); with USE_SEQ_CONSISTENCY st_batch also holds shuffled
(B, T, 64, 64, 3) and order_labels (B,). The metric tags are the JAX step's
for each variant: no seg_D/* without a seg D.

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

In a process group (`parallel/`) the batches are this rank's data shard of
the global batch (`data/loader.py` slices them), and the step is the JAX
package's one program over the global batch, its collectives stated over the
rank's data group (the ranks of the other mesh axes, replicas, repeat the
same work on the same rows and noise, as the JAX program does there):
  * the noise: the global batch's draws from `rng`, of which the rank keeps
    its rows, so the draws do not depend on the rank count (explicit draws
    are the global batch's too);
  * each loss is this rank's share, its rows' sum over the global count
    (`losses/gan_losses.py`), the BN statistics global (`ops/batchnorm.py`),
    the cross-rank pairs from the global index (`models/discriminators.py`);
  * `torch.autograd.grad` fires no DistributedDataParallel hook, and the
    nets are not wrapped in one: after it each net's gradients are summed
    over the data group in one all-reduce of their concatenation, so every
    rank takes the same Adam step and the parameters stay equal bit for bit;
  * the metrics are the data group's shares summed in one all-reduce a step.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.device import float32_math
from cpcsv_tpu_torch.losses.gan_losses import (
    GLossOut,
    batch_mean,
    discriminator_loss,
    generator_loss,
    kl_loss,
)
from cpcsv_tpu_torch.parallel.distributed import form_data_groups, is_distributed
from cpcsv_tpu_torch.parallel.mesh import (
    all_reduce_sum_,
    batch_rows,
    check_training_mesh,
    wrong_pair_rows,
)
from cpcsv_tpu_torch.train.graphs import PairGraph, PairGraphs
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


def _mse(a: torch.Tensor, b: torch.Tensor, rows=None) -> torch.Tensor:
    return batch_mean(torch.square(a.float() - b.float()), rows)


def _latent_loss(latents, rows=None) -> torch.Tensor:
    (h1, h2, h3, h4), (g1, g2, g3, g4) = latents
    return _mse(g1, h1, rows) + _mse(g2, h2, rows) + _mse(g3, h3, rows) + _mse(g4, h4, rows)


def _rows(batch: dict, key: str = "images"):
    """This rank's `mesh.Rows` of the batch, None without a process group."""
    return batch_rows(batch[key].shape[0]) if is_distributed() else None


def _local_noise(noise, rows):
    """This rank's rows of the global batch's draws."""
    if rows is None:
        return noise
    return tuple(n[rows.lo:rows.lo + rows.local] for n in noise)


def _sample_all(cfg: Config, net_g, rng, st_batch, im_batch):
    st_motion = torch.cat([st_batch["description"], st_batch["labels"]], dim=2)
    im_motion = torch.cat([im_batch["description"], im_batch["labels"]], dim=1)
    im_content = im_batch["content"][:, :, : cfg.TEXT.DIMENSION]
    st_rows, im_rows = _rows(st_batch), _rows(im_batch)
    if isinstance(rng, torch.Generator):
        st_noise = net_g.draw_noise(st_rows.total if st_rows else st_motion.shape[0],
                                    st_motion.shape[1], rng)
        im_noise = net_g.draw_noise(im_rows.total if im_rows else im_motion.shape[0], 1, rng)
    else:
        st_noise, im_noise = rng
    st_noise, im_noise = _local_noise(st_noise, st_rows), _local_noise(im_noise, im_rows)
    # the cascade reads the story call's mask and latents in the G step
    st_out = net_g.sample_videos(st_motion, st_batch["description"], seg=cfg.CASCADE_MODEL,
                                 noise=st_noise)
    im_out = net_g.sample_images(im_motion, im_content, seg=True, noise=im_noise)
    return st_out, im_out


def _step(net, opt, loss) -> None:
    """One optimizer step of `net` on d loss / d params, at the learning rate
    set on `opt` (`Adam.set_lr`). Gradients go to this net only; a parameter
    the loss does not reach steps with a zero gradient, as optax's Adam
    does. In a process group the gradients are summed over the data group
    first, in one all-reduce of their concatenation."""
    params = list(net.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p) for p, g in zip(params, grads)]
    if is_distributed():
        flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]))
        grads = [f.view_as(p) for f, p in zip(flat.split([p.numel() for p in params]), params)]
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def _reduce_metrics(metrics: dict) -> dict:
    """The metrics' shares summed over the data group, in one all-reduce;
    without a process group the metrics as they are."""
    if not is_distributed():
        return metrics
    values = all_reduce_sum_(torch.stack([v.detach().float().reshape(()) for v in metrics.values()]))
    return dict(zip(metrics, values.unbind()))


def set_learning_rates(state: TrainState, lr_d: float, lr_g: float) -> None:
    """The discriminators' Adams at lr_d and the generator's at lr_g."""
    for name, opt in state.opts.items():
        opt.set_lr(lr_g if name == "gen" else lr_d)


def make_train_steps(cfg: Config):
    """(d_step, g_step), each (state, rng, st_batch, im_batch, lr) ->
    (state, metrics). Unlike the JAX package's, it takes no models: the nets
    are modules that live in the state. cfg.MESH_SHAPE must be a training
    mesh of the process group (`mesh.check_training_mesh`); each step runs
    its collectives over that mesh's data groups."""
    on_mesh, d_pass, g_pass = _passes(cfg)

    def d_step(state: TrainState, rng, st_batch, im_batch, lr_d):
        on_mesh()
        for name, opt in state.opts.items():
            if name != "gen":
                opt.set_lr(lr_d)
        return state, d_pass(state, rng, st_batch, im_batch)

    def g_step(state: TrainState, rng, st_batch, im_batch, lr_g):
        on_mesh()
        state.opts["gen"].set_lr(lr_g)
        metrics = g_pass(state, rng, st_batch, im_batch)
        state.step += 1
        return state, metrics

    return d_step, g_step


def _passes(cfg: Config):
    """(on_mesh, d_pass, g_pass): the D and the G update, each (state, rng,
    st_batch, im_batch) -> metrics, at the learning rates set on the
    Adams, leaving `state.step` as it is, with no host work a CUDA graph
    could not capture; and the host work that must precede them."""
    seg_w, img_w, kl = cfg.SEGMENT_RATIO, cfg.IMAGE_RATIO, cfg.TRAIN.COEFF.KL
    use_segment, nce = cfg.SEGMENT_LEARNING, cfg.USE_INFONCE
    layout = check_training_mesh(cfg.MESH_SHAPE)

    def on_mesh():
        """In a process group, this mesh's data groups become the
        collectives' (steps of another mesh may have run since)."""
        if is_distributed():
            form_data_groups(layout.groups)

    def d_update(net, opt, real, fake, cond, cate_labels, extra=None):
        """One D's Adam step (`cpcsv_tpu/train/steps.py:one_d`). `extra` is the
        story D's: a dict, empty without the shuffle branch; the image and
        seg Ds get None (dispatch on `is not None`, not on truthiness)."""
        net.train()
        story = extra is not None
        rows = batch_rows(real.shape[0]) if is_distributed() else None
        args = (real, fake, cond) + ((extra.get("shuffled"),) if story else ())
        if nce:
            pair, fake_logits, third = net.d_phase_infonce(*args)
            real_logits, wrong_logits = torch.diagonal(pair, offset=rows.lo if rows else 0), None
        else:
            real_logits, wrong_logits, fake_logits, third = net.d_phase(*args)
            pair = None
        # the third output: the story D's order logits, the others' cate logits
        cate, order = (None, third) if story else (third, None)
        out = discriminator_loss(real_logits, wrong_logits, fake_logits, cate, cate_labels, order,
                                 extra.get("order_labels") if story else None,
                                 cfg.CONSISTENCY_RATIO, pair_logits=pair,
                                 infonce_temperature=cfg.INFONCE_TEMPERATURE, rows=rows,
                                 wrong_rows=wrong_pair_rows(rows) if rows else None)
        _step(net, opt, out.total)
        return out

    def d_pass(state: TrainState, rng, st_batch, im_batch):
        device = next(state.gen.parameters()).device
        st_batch, im_batch = batch_to_device(st_batch, device), batch_to_device(im_batch, device)
        with float32_math():
            state.gen.train()
            with torch.no_grad():
                st_out, im_out = _sample_all(cfg, state.gen, rng, st_batch, im_batch)
            st_mu, im_mu = build_conditions(st_batch, im_batch, st_out.c_mu, im_out.c_mu)
            labels = im_batch["labels"]
            metrics = {}
            if use_segment:
                se = d_update(state.d_se, state.opts["d_se"], im_batch["images_seg"],
                              im_out.seg, im_mu, labels)
                metrics = {"seg_D/loss": se.total, "seg_D/real": se.real,
                           "seg_D/fake": se.fake, "Accuracy/se_D": se.accuracy}
            im = d_update(state.d_im, state.opts["d_im"], im_batch["images"], im_out.image,
                          im_mu, labels)
            st_extra = ({"shuffled": st_batch["shuffled"], "order_labels": st_batch["order_labels"]}
                        if cfg.USE_SEQ_CONSISTENCY else {})
            st = d_update(state.d_st, state.opts["d_st"], st_batch["images"], st_out.image,
                          st_mu, None, st_extra)
        metrics.update({
            "img_D/loss": im.total, "img_D/real": im.real, "img_D/fake": im.fake,
            "Accuracy/im_D": im.accuracy,
            "st_D/loss": st.total, "st_D/real": st.real, "st_D/fake": st.fake,
            "st_D/order": st.consistency,
        })
        return _reduce_metrics({k: v.detach() for k, v in metrics.items()})

    def g_pass(state: TrainState, rng, st_batch, im_batch):
        device = next(state.gen.parameters()).device
        st_batch, im_batch = batch_to_device(st_batch, device), batch_to_device(im_batch, device)
        with float32_math():
            for net in state.nets().values():
                net.train()
            st_out, im_out = _sample_all(cfg, state.gen, rng, st_batch, im_batch)
            st_mu, im_mu = build_conditions(st_batch, im_batch, st_out.c_mu, im_out.c_mu)
            st_mu, im_mu = st_mu.detach(), im_mu.detach()  # the reference detaches them
            labels = im_batch["labels"]
            st_rows, im_rows = _rows(st_batch), _rows(im_batch)
            if use_segment:
                se_g = generator_loss(*state.d_se.g_phase(im_out.seg, im_mu), labels,
                                      rows=im_rows)
            else:
                zero = im_mu.new_zeros(())
                se_g = GLossOut(zero, zero, zero)
            im_g = generator_loss(*state.d_im.g_phase(im_out.image, im_mu), labels, rows=im_rows)
            fake_logits, cons_fake, cons_real = state.d_st.g_phase(st_out.image, st_mu,
                                                                   st_batch["images"])
            st_g = generator_loss(fake_logits, None, None, cons_fake, cons_real,
                                  cfg.CONSISTENCY_RATIO, rows=st_rows)
            im_kl = kl_loss(im_out.c_mu, im_out.c_logvar, im_rows)
            st_kl = kl_loss(st_out.c_mu, st_out.c_logvar, st_rows)
            total = im_g.total + im_kl * kl + (se_g.total * seg_w + st_g.total * img_w + st_kl * kl)
            cascade = {}
            if cfg.CASCADE_MODEL:
                se_real = im_batch["images_seg"]
                recon_real = state.gen.train_autoencoder(se_real)
                recon_fake = state.gen.train_autoencoder(im_out.seg)
                cascade = {
                    "G/image_vae_loss": _latent_loss(im_out.latents, im_rows),
                    "G/video_vae_loss": _latent_loss(st_out.latents, st_rows),
                    "G/reconstruct_loss": (_mse(recon_real, se_real, im_rows)
                                           + _mse(recon_fake, im_out.seg, im_rows)) / 2.0,
                }
                total = total + (cascade["G/video_vae_loss"]
                                 + cascade["G/reconstruct_loss"]) * cfg.RECONSTRUCT_LOSS
            _step(state.gen, state.opts["gen"], total)
        metrics = {
            **cascade,
            "G/im_KL": im_kl, "G/st_KL": st_kl, "G/KL": im_kl + st_kl,
            "G/consistency": st_g.consistency,
            "Accuracy/im_G": im_g.accuracy, "Accuracy/se_G": se_g.accuracy,
            "Accuracy/st_G": st_g.accuracy,
            "G/gan_loss": im_g.total + (img_w * st_g.total + se_g.total * seg_w),
            "G/loss": total,
        }
        return _reduce_metrics({k: v.detach() for k, v in metrics.items()})

    return on_mesh, d_pass, g_pass


def captures_chunks(device: torch.device) -> bool:
    """Whether `make_scan_steps` replays a CUDA graph of the D+G pair on
    `device`: on a CUDA device alone or under NCCL, whose collectives a
    graph captures; not on the CPU, and not under gloo, which stages its
    collectives through the host. Decided by the device and the backend,
    never by trying a capture."""
    if device.type != "cuda":
        return False
    return not is_distributed() or dist.get_backend() == "nccl"


def make_scan_steps(cfg: Config):
    """scan_steps(state, rng, st_batches, im_batches, lr_d, lr_g) -> (state,
    metrics): K alternating D+G updates, the counterpart of
    `cpcsv_tpu/train/steps.py:make_scan_steps` (K pairs in one `lax.scan`
    dispatch). Every batch leaf carries a leading K axis, every metric comes
    back stacked over K, as one (K,) tensor of one (K, M) device buffer that
    a caller reads back in one copy, and `state.step` advances by K. The
    updates are `make_train_steps`' D step then G step, K times.

    `rng` is a `torch.Generator` on the nets' device, from which each pair
    draws its noise as the steps draw it, or K explicit (d_noise, g_noise)
    pairs of the steps' draws. The learning rates reach the Adams through
    their device tensors (`Adam.set_lr`), set once before the pairs.

    Where `captures_chunks` says so, the pairs run as a CUDA graph
    (`train/graphs.py`): the first pair at a set of input shapes runs
    eagerly on the graph's input buffers, a real update that also warms
    cuDNN and the allocator, and is then captured once; every later pair at
    those shapes, in this chunk or a later one, copies its inputs into the
    buffers and replays the graph, with no host sync inside the chunk. A
    chunk's last pair at shapes with no graph yet runs eagerly and captures
    nothing. These pairs run on a side stream of their own
    (`graphs.PairGraphs.stream`). A capture that fails raises. Elsewhere
    each pair runs eagerly.
    A replay gives an eager pair's bits: the same kernels on the same
    inputs, the generator registered with the graph (`graphs.PairGraph`)."""
    on_mesh, d_pass, g_pass = _passes(cfg)
    graphs = PairGraphs()
    tags: list[str] = []  # the metrics' names, in the order of a pair's row

    def pair(state: TrainState, rng, inputs) -> torch.Tensor:
        """One D+G pair on inputs (st_batch, im_batch), or (st_batch,
        im_batch, (d_noise, g_noise)): its metrics as one float32 row."""
        st_batch, im_batch, *noise = inputs
        d_rng, g_rng = noise[0] if noise else (rng, rng)
        metrics = {**d_pass(state, d_rng, st_batch, im_batch),
                   **g_pass(state, g_rng, st_batch, im_batch)}
        tags[:] = metrics
        return torch.stack([v.float().reshape(()) for v in metrics.values()])

    def scan_steps(state: TrainState, rng, st_batches, im_batches, lr_d, lr_g):
        on_mesh()
        device = next(state.gen.parameters()).device
        st_batches = batch_to_device(st_batches, device)
        im_batches = batch_to_device(im_batches, device)
        K = st_batches["images"].shape[0]
        draws = None if isinstance(rng, torch.Generator) else list(rng)
        if draws is not None and len(draws) != K:
            raise ValueError(f"{len(draws)} explicit noise draws for {K} pairs")
        generator = rng if draws is None else None
        set_learning_rates(state, lr_d, lr_g)
        captured = captures_chunks(device)
        with graphs.stream(device) if captured else contextlib.nullcontext():
            rows = run_pairs(state, generator, st_batches, im_batches, draws, K, captured)
        if captured:  # made on the pairs' stream, read on this one
            rows.record_stream(torch.cuda.current_stream(device))
        state.step += K
        return state, dict(zip(tags, rows.unbind(1)))

    def run_pairs(state, generator, st_batches, im_batches, draws, K, captured):
        """The chunk's K pairs: replays, or eager pairs (a first one
        captured where more follow); their metrics as a (K, M) tensor."""
        rows = None
        for k in range(K):
            inputs = ({n: v[k] for n, v in st_batches.items()},
                      {n: v[k] for n, v in im_batches.items()}) + (() if draws is None
                                                                    else (draws[k],))
            graph = graphs.get(inputs, generator) if captured else None
            if graph is not None:
                row = graph.replay(inputs)
            elif captured and k + 1 < K:  # more pairs of these shapes follow
                graph = PairGraph(inputs, generator)
                row = pair(state, generator, graph.inputs)
                graph.capture(pair, state)
                graphs.add(graph)
            else:  # fresh tensors, as a pair outside a chunk gets
                row = pair(state, generator, tree_map(torch.clone, inputs))
            if rows is None:
                rows = torch.empty((K, row.numel()), dtype=row.dtype, device=row.device)
            rows[k].copy_(row)
        return rows

    scan_steps.graphs = graphs
    return scan_steps
