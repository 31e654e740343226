"""Inference and evaluation drivers (counterpart of
`cpcsv_tpu/evaluation/drivers.py`; reference `inference.py:32-230`), with
the reference's file protocol:

  * `generate_story`: Evaluation/{name}/{dirname}/{original,generate}/{i}/{t}.png
    (inference.py:147-199);
  * `inference_samples`: numbered PNGs {1..N}.png of the generated frames,
    and of the real ones under <run>/Evaluation/ref (miscc/utils.py:402-428);
  * `eval_fid2`: the run's generator snapshots, newest first, each
    regenerating the test stories and appending "epoch,fid,fsd" to
    Evaluation/{name}/fid_score2.csv (inference.py:201-230);
  * `eval_ssim_walk`: the same walk, appending "epoch,ssim" to
    Evaluation/{name}/ssim_score.csv;
  * `eval_is`: the same walk over is_epoch_{E}/generate, appending
    "epoch,mean,std" of the Inception Score to Evaluation/{name}/is_score.csv;
  * `eval_fvd`: each snapshot's numbered dump in fvd_epoch_{E}/ beside
    <run>/Evaluation/ref, appending "epoch,fvd" to
    Evaluation/{name}/fvd_score.csv (inference.py:128-141);
  * `evaluate_fid_fsd_in_memory`: the trainer's per-epoch FID and FSD
    (reference trainer.py:160-174), no PNGs, the real side's statistics
    cached under ./.cache/.

`Infer` holds an eval-mode generator on one device. It takes the weights
either as a `state_dict` (a `netG_epoch_E.pth`, or JAX variables converted
by `utils.weights.generator_state_dict_from_jax`) or from the run directory
`output_dir` (`load_ckpt=E`, `load_epoch(E)`, and the walks). Noise comes
from one `torch.Generator` on the device, seeded with `seed`. Every
generation call goes through `sampling.sample`, as every JAX one through a
jitted sampler: on a card the graphs captured at a walk's first snapshot
replay on the next, whose weights `load_epoch` copies in place.

In a process group the walks and the --load_ckpt dump run on rank 0 alone,
over the whole test set (`_centralized`, as the JAX package's); `Infer`
takes any MESH_SHAPE and walks on its one device, as the JAX package's
`make_eval_mesh` falls back to the local devices, with the same numbers.
The port never wrote the JAX package's legacy params-only snapshots, so it
does not read them.
"""

from __future__ import annotations

import csv
import functools
import os
import shutil
from typing import Optional

import numpy as np
import torch

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.device import resolve_device
from cpcsv_tpu_torch.evaluation import sampling
from cpcsv_tpu_torch.evaluation.datasets import (
    FolderImageDataset,
    FolderStoryDataset,
    IgnoreLabelDataset,
    StoryGANDataset,
    StoryGANSSIMDataset,
)
from cpcsv_tpu_torch.evaluation.fid import fid_score
from cpcsv_tpu_torch.evaluation.fsd import fsd_score
from cpcsv_tpu_torch.evaluation.fvd import calculate_fvd, default_embedder
from cpcsv_tpu_torch.evaluation.inception import (
    make_inception_classifier,
    make_inception_extractor,
)
from cpcsv_tpu_torch.evaluation.inception_score import inception_score
from cpcsv_tpu_torch.evaluation.r2plus1d import make_fsd_extractor
from cpcsv_tpu_torch.evaluation.ssim import ssim_score
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.parallel.distributed import is_distributed, process_info
from cpcsv_tpu_torch.parallel.mesh import host_barrier
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.utils.image import save_all_img, save_png, save_story_results


def _centralized(walk):
    """A checkpoint walk (first argument the test loader) in a process group
    (`cpcsv_tpu/evaluation/drivers.py:61-98`): every rank of a CLI run reaches
    the same walk, which runs on rank 0 alone over the loader's unsliced
    view, the whole test set (the reference evaluates on one GPU); the other
    ranks wait and return None. The wait is a barrier of the host's gloo
    group (`mesh.host_barrier`, CPCSV_EVAL_BARRIER_MIN's timeout), not a
    NCCL collective, whose timeout a walk of minutes to hours would pass.
    Without a group the walk runs as it is."""

    @functools.wraps(walk)
    def wrapper(self, loader, *args, **kwargs):
        if not is_distributed():
            return walk(self, loader, *args, **kwargs)
        if process_info()[0] != 0:
            host_barrier()
            return None
        try:
            full = loader.unsliced() if hasattr(loader, "unsliced") else loader
            return walk(self, full, *args, **kwargs)
        finally:
            try:
                host_barrier()
            except Exception as e:  # a waiter that gave up must not discard the walk
                print(f"warning: the barrier after {walk.__name__} failed ({e}); "
                      "the walk's results are intact")

    return wrapper


def _batch_motion_content(cfg: Config, batch):
    """(motion (B, T, 365), content (B, T, 356)) host arrays of a story batch:
    motion is the description followed by the labels."""
    desc = np.asarray(batch["description"], np.float32)[:, :, : cfg.TEXT.DIMENSION]
    labels = np.asarray(batch["labels"], np.float32)
    return np.concatenate([desc, labels], axis=2), desc


def _append_row(path: str, row: list) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a", newline="") as f:
        csv.writer(f).writerow(row)


class Infer:
    """Eval-mode story generation and the checkpoint walks on one device."""

    def __init__(
        self,
        cfg: Config,
        state_dict: Optional[dict[str, torch.Tensor]] = None,
        device: str | torch.device = "cuda",
        output_dir: str = "output",
        seed: int = 0,
        load_ckpt: Optional[int] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = output_dir
        self.model_dir = os.path.join(output_dir, "Model")
        self.eval_dir = os.path.join(output_dir, "Evaluation", cfg.CONFIG_NAME or "eval")
        self.net_g = generator_from_config(cfg)
        self.loaded = state_dict is not None
        if self.loaded:
            self.net_g.load_state_dict(state_dict, strict=True)
        self.net_g.to(self.device).eval().requires_grad_(False)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if load_ckpt is not None:
            self.load_epoch(int(load_ckpt))

    @functools.cached_property
    def ckpt(self) -> CheckpointManager:
        return CheckpointManager(self.model_dir)

    def load_epoch(self, epoch: int) -> None:
        """The generator of the run's netG_epoch_{epoch}.pth, its BN statistics
        included (reference inference.py:82-89). A missing snapshot raises
        FileNotFoundError naming the run's Model directory: scores of an
        untrained generator must never pass for a checkpoint's."""
        self.net_g.load_state_dict(self.ckpt.restore_generator(epoch), strict=True)
        self.loaded = True

    def _epochs(self, walk: str, epochs: Optional[list[int]]) -> list[int]:
        """The epochs a walk covers: `epochs`, or every snapshot newest first."""
        epochs = epochs or sorted(self.ckpt.available_generator_epochs(), reverse=True)
        if not epochs:
            raise FileNotFoundError(
                f"{walk}: no generator checkpoints under {self.model_dir}: wrong output "
                "directory, or training never saved a snapshot")
        return epochs

    def sample_videos_np(self, batch, seg: bool = False):
        """Story batch -> (video (B, T, 64, 64, 3), mask (B*T, 64, 64, 1) or
        None), numpy float32, computed in cfg.COMPUTE_DTYPE (float32 whatever
        the global TF32 flags say, or bfloat16) through the sampler
        (`sampling.sample`: on a card a CUDA graph replayed after the first
        call at a set of shapes), its noise from `self.generator`."""
        if not self.loaded:
            raise RuntimeError(
                "no generator weights: pass a state_dict, or load_ckpt=E or load_epoch(E) "
                f"for a snapshot of {self.model_dir}")
        motion, content = _batch_motion_content(self.cfg, batch)
        image, mask = sampling.sample(self.net_g, torch.from_numpy(motion).to(self.device),
                                      torch.from_numpy(content).to(self.device), seg=seg,
                                      generator=self.generator)
        mask = mask.float().cpu().numpy() if mask is not None else None
        return image.float().cpu().numpy(), mask

    # ------------------------------------------------------------------ dumps
    def generate_story(self, storyloader, dirname: str = "", skip_original: bool = False):
        """original/ and generate/ folder trees (reference inference.py:147-199).
        Both trees are cleared first, so a smaller walk leaves no stale stories.
        `skip_original` writes no original/ (eval_is reads generated frames only)."""
        orig_dir = os.path.join(self.eval_dir, dirname, "original")
        gen_dir = os.path.join(self.eval_dir, dirname, "generate")
        for d in (orig_dir, gen_dir):
            if os.path.isdir(d):
                shutil.rmtree(d)
        story_id = 0
        for batch in storyloader:
            fake, _ = self.sample_videos_np(batch)
            real = np.asarray(batch["images"], np.float32)
            trees = ((gen_dir, fake),) if skip_original else ((gen_dir, fake), (orig_dir, real))
            for b in range(fake.shape[0]):
                for root, frames in trees:
                    d = os.path.join(root, str(story_id))
                    os.makedirs(d, exist_ok=True)
                    for t in range(fake.shape[1]):
                        save_png(frames[b, t], os.path.join(d, f"{t}.png"))
                story_id += 1
        return orig_dir, gen_dir

    @_centralized
    def inference_samples(self, storyloader, save_path: str):
        """The --load_ckpt dump (reference miscc/utils.py:402): the generated
        frames as numbered PNGs in `save_path`, the real ones in
        <run>/Evaluation/ref. Both directories are cleared of PNGs first: a
        larger earlier dump would otherwise mix two models' frames."""
        return self._inference_samples(storyloader, save_path)

    def _inference_samples(self, storyloader, save_path: str):
        ref_dir = os.path.join(self.output_dir, "Evaluation", "ref")
        for d in (save_path, ref_dir):
            if os.path.isdir(d):
                for f in os.listdir(d):
                    if f.endswith(".png"):
                        os.remove(os.path.join(d, f))
        cnt_gen = cnt_ref = 0
        for batch in storyloader:
            fake, _ = self.sample_videos_np(batch)
            cnt_gen = save_all_img(fake, cnt_gen, save_path)
            cnt_ref = save_all_img(np.asarray(batch["images"], np.float32), cnt_ref, ref_dir)
        return save_path, ref_dir

    # ------------------------------------------------------------------ walks
    @_centralized
    def eval_fid2(self, testloader, epochs: Optional[list[int]] = None, batch_size: int = 50):
        """FID and FSD of each snapshot, newest first (reference
        inference.py:201-230): the test stories regenerated into
        epoch_{E}/{original,generate}, read back, scored, and appended to
        fid_score2.csv. The extractors are built once a walk, from the weights
        files of the search directories (`weights.resolve_weights`); every row
        says whether they ran from random init."""
        cfg = self.cfg
        epochs = self._epochs("eval_fid2", epochs)
        csv_path = os.path.join(self.eval_dir, "fid_score2.csv")
        fid_ex = make_inception_extractor(None, self.device)
        fsd_ex = make_fsd_extractor(None, self.device)
        results = []
        for epoch in epochs:
            self.load_epoch(epoch)
            orig_dir, gen_dir = self.generate_story(testloader, f"epoch_{epoch}")
            stories = len(os.listdir(orig_dir))
            fsd = fsd_score(
                FolderStoryDataset(orig_dir, cfg.VIDEO_LEN, cfg.IMSIZE),
                FolderStoryDataset(gen_dir, cfg.VIDEO_LEN, cfg.IMSIZE),
                batch_size=min(batch_size, stories), extractor=fsd_ex)
            fid = fid_score(
                FolderImageDataset(orig_dir, cfg.IMSIZE), FolderImageDataset(gen_dir, cfg.IMSIZE),
                batch_size=min(batch_size, stories * cfg.VIDEO_LEN), normalize=True,
                extractor=fid_ex)
            _append_row(csv_path, [epoch, fid, fsd])
            results.append({"epoch": epoch, "fid": fid, "vfid": fsd,
                            "fid_random_init": fid_ex.random_init,
                            "fsd_random_init": fsd_ex.random_init})
            tag = (" [RANDOM-INIT extractors!]"
                   if fid_ex.random_init or fsd_ex.random_init else "")
            print(f"epoch {epoch}: fid={fid:.3f} vfid/fsd={fsd:.3f}{tag}")
        return results

    @_centralized
    def eval_is(self, testloader, epochs: Optional[list[int]] = None, batch_size: int = 32,
                splits: int = 10):
        """Inception Score of each snapshot, newest first: the test stories
        regenerated into is_epoch_{E}/generate (its own directory, so an
        eval_fid2 walk's original/ trees stay), their frames scored, and
        [epoch, mean, std] appended to is_score.csv. The reference ships the
        score (fid/inception_score.py:10-68) and wires no walk. One classifier
        for the walk; every row says whether it is random."""
        epochs = self._epochs("eval_is", epochs)
        csv_path = os.path.join(self.eval_dir, "is_score.csv")
        classifier = make_inception_classifier(None, device=self.device)
        results = []
        for epoch in epochs:
            self.load_epoch(epoch)
            _, gen_dir = self.generate_story(testloader, f"is_epoch_{epoch}", skip_original=True)
            mean, std = inception_score(FolderImageDataset(gen_dir, self.cfg.IMSIZE), classifier,
                                        batch_size=batch_size, splits=splits, normalize=True)
            _append_row(csv_path, [epoch, mean, std])
            results.append({"epoch": epoch, "is_mean": mean, "is_std": std,
                            "is_random_init": classifier.random_init})
            tag = " [RANDOM-INIT classifier!]" if classifier.random_init else ""
            print(f"epoch {epoch}: IS={mean:.3f}+-{std:.3f}{tag}")
        return results

    @_centralized
    def eval_fvd(self, storyloader, epochs: Optional[list[int]] = None,
                 num_of_video: int = 272):
        """FVD of each snapshot, newest first (reference inference.py:128-141):
        the numbered dump of the test stories in fvd_epoch_{E}/ against the
        real frames in <run>/Evaluation/ref, [epoch, fvd] appended to
        fvd_score.csv. One embedder for the walk (`fvd.default_embedder`: I3D
        when its weights resolve, else R(2+1)D); every row says whether it is
        random."""
        epochs = self._epochs("eval_fvd", epochs)
        csv_path = os.path.join(self.eval_dir, "fvd_score.csv")
        embedder = default_embedder(None, self.device)
        results = []
        for epoch in epochs:
            self.load_epoch(epoch)
            gen_dir, ref_dir = self._inference_samples(
                storyloader, os.path.join(self.eval_dir, f"fvd_epoch_{epoch}"))
            fvd = calculate_fvd(gen_dir, ref_dir, num_of_video=num_of_video, embedder=embedder)
            _append_row(csv_path, [epoch, fvd])
            results.append({"epoch": epoch, "fvd": fvd, "fvd_random_init": embedder.random_init})
            tag = " [RANDOM-INIT embedder!]" if embedder.random_init else ""
            print(f"epoch {epoch}: fvd={fvd:.3f}{tag}")
        return results

    def save_test_samples(self, storyloader, save_path: str):
        """Each batch's texts (fake_samples_{i}.txt), and images.npy /
        labels.npy of every generated story (reference miscc/utils.py:343-399)."""
        os.makedirs(save_path, exist_ok=True)
        images, labels = [], []
        for i, batch in enumerate(storyloader):
            fake, _ = self.sample_videos_np(batch)
            save_story_results(np.asarray(batch["images"], np.float32), fake,
                               batch.get("text"), f"{i:03d}", save_path)
            images.append(fake)
            labels.append(np.asarray(batch["labels"], np.float32))
        np.save(os.path.join(save_path, "images.npy"), np.concatenate(images, 0))
        np.save(os.path.join(save_path, "labels.npy"), np.concatenate(labels, 0))

    def inference(self, imageloader=None, storyloader=None, testloader=None, stage: int = 1):
        """The reference's Infer.inference surface (inference.py:91-145): the
        loaded snapshot's numbered dump in Evaluation/{name}/samples."""
        return self.inference_samples(testloader or storyloader,
                                      os.path.join(self.eval_dir, "samples"))

    def eval_fid(self, testloader, epochs: Optional[list[int]] = None, batch_size: int = 50):
        """The reference's name for the same walk (inference.py:114-126)."""
        return self.eval_fid2(testloader, epochs=epochs, batch_size=batch_size)

    def eval_ssim(self, testdataset, n: Optional[int] = None) -> float:
        """Mean SSIM of the loaded generator's stories against the real ones
        they were generated from, over the first `n` items (default all)."""
        if not self.loaded:
            raise RuntimeError(f"eval_ssim: no generator loaded (snapshots in {self.model_dir})")
        ds = StoryGANSSIMDataset(self.net_g, testdataset, self.generator,
                                 text_dim=self.cfg.TEXT.DIMENSION)
        n = n or len(ds)
        return ssim_score((ds[i] for i in range(n)), device=self.device)

    @_centralized
    def eval_ssim_walk(self, testloader, epochs: Optional[list[int]] = None,
                       n: Optional[int] = None):
        """SSIM of each snapshot, newest first, appended to ssim_score.csv.
        The reference ships the SSIM scorer (ssim_score.py:13-28) and wires
        no walk; this one walks as eval_fid2 does."""
        epochs = self._epochs("eval_ssim", epochs)
        csv_path = os.path.join(self.eval_dir, "ssim_score.csv")
        results = []
        for epoch in epochs:
            self.load_epoch(epoch)
            val = self.eval_ssim(testloader.dataset, n=n)
            _append_row(csv_path, [epoch, val])
            results.append({"epoch": epoch, "ssim": val})
            print(f"epoch {epoch}: ssim={val:.4f}")
        return results


# ------------------------------------------------------------------ in training
def make_in_memory_extractors(device: str | torch.device = "cuda"):
    """(FID's Inception, FSD's R(2+1)D) on `device`, built once a run: the
    trainer holds them across epochs, so their random-init warnings come
    once."""
    return make_inception_extractor(None, device), make_fsd_extractor(None, device)


def evaluate_fid_fsd_in_memory(cfg: Config, net_g, testloader, generator: torch.Generator,
                               extractors=None) -> dict:
    """The trainer's per-epoch FID and FSD (reference trainer.py:160-174):
    `net_g` (in eval mode, on its device) regenerates the test stories with
    noise from `generator`, and the stories are scored in memory, no PNGs.

    The real side's statistics are cached in ./.cache/ (as the reference's),
    each file keyed by the extractor's weights fingerprint
    (`features.activation_statistics`) and by a tag of the test set (its
    directory's name, its size, the frame size and the story length): the
    reference's unkeyed files would hand one dataset's statistics to
    another's run from the same directory."""
    testdataset = testloader.dataset
    gen_ds = StoryGANDataset(net_g, testdataset, generator, cfg.TEXT.DIMENSION)
    real_ds = IgnoreLabelDataset(testdataset)
    fid_ex, fsd_ex = extractors or make_in_memory_extractors(next(net_g.parameters()).device)
    tag = "{}_{}_{}x{}".format(os.path.basename(str(cfg.DATA_DIR).rstrip("/")) or "data",
                               len(testdataset), cfg.IMSIZE, cfg.VIDEO_LEN)
    fsd = fsd_score(real_ds, gen_ds, batch_size=min(50, len(testdataset)),
                    r_cache=f".cache/seg_story_vfid_reference_score.{tag}.npz", extractor=fsd_ex)
    fid = fid_score(real_ds, gen_ds, batch_size=min(50, len(testdataset) * cfg.VIDEO_LEN),
                    normalize=True, r_cache=f".cache/seg_story_fid_reference_score.{tag}.npz",
                    extractor=fid_ex)
    return {"fid": fid, "fsd": fsd, "fid_random_init": fid_ex.random_init,
            "fsd_random_init": fsd_ex.random_init}
