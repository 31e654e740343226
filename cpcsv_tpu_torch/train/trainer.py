"""GANTrainer, the training driver (counterpart of `cpcsv_tpu/train/trainer.py`;
reference `trainer.py:42-485`).

Per epoch: iterate the story loader, draw the image loader in lockstep (it
wraps around), run the D step then the G step, log scalars under the
reference's tensorboard tag names (`st_D/*` every step, the rest every 20),
render the epoch sample grid, log the learning rates (the reference's manual
halving with a doubling interval, `lr_at_epoch`), frames/s and the epoch's
seconds, and save a checkpoint every SNAPSHOT_INTERVAL epochs and at the end.

Every epoch's randomness comes from (seed, epoch): one `torch.Generator` for
the steps' noise, one for the sample grid, the loaders' `set_epoch`, and,
with USE_SEQ_CONSISTENCY, the numpy generator `default_rng([seed, epoch])`
of the host-side story shuffle (`_augment_story_host`, as
`cpcsv_tpu/train/trainer.py:126-134,218-227`), so a resumed epoch E trains
exactly as an uninterrupted run's epoch E.

The host-to-card copy of the next pair of batches is made on a background
thread and a side stream while the card runs the current step
(`data/prefetch.py`). A D+G pair's metrics come back in one copy, as in the
JAX package.

With SCAN_STEPS K > 1 (every shipped config: 20) the epoch runs in chunks
of K pairs, as `cpcsv_tpu/train/trainer.py:292-355` does: K host batches
stacked on a leading axis (the story batches augmented first), a chunk
flushed early where a ragged batch changes the shapes, a shorter last
chunk, the stack copied to the card while the previous chunk runs (one
chunk in flight), the K pairs run by `steps.make_scan_steps`, and their
metrics read back once a chunk and logged a step at a time, so
`metrics.jsonl` holds the rows of K = 1. On a CUDA device, alone or under
NCCL, a chunk's pairs replay a CUDA graph of the D+G pair (`train/graphs.py`);
on the CPU and under gloo they run eagerly (`steps.captures_chunks`); the
run prints which once. The steps' generator is one object, reseeded every
epoch, so that a graph captured in one epoch draws the next epoch's noise.

With EVALUATE_FID_SCORE, each epoch ends with the test set's FID and FSD
(`calculate_vfid`, reference trainer.py:160-174), logged as Evaluation/fid
and Evaluation/vfid; their seconds count in the epoch's, as in the JAX
package. The extractors are built at the first epoch's hook and kept. The
sample grid, the hook and `calculate_ssim` generate through the sampler
(`evaluation/sampling.py`: on a card CUDA graphs that each epoch replays),
each from one generator the trainer keeps and reseeds every epoch.

The run directory archives itself (reference trainer.py:55-61): the YAML
config and the port's generator and trainer sources are copied into it.

With CPCSV_PROFILE_DIR set, the run traces with torch.profiler into that
directory (`utils/profiling.py`), as the JAX trainer traces with
jax.profiler: with K > 1 the second chunk of the first epoch that has one,
its first warm chunk (`cpcsv_tpu/train/trainer.py:341-350`); with K = 1
steps 2-5 (or to its end) of the first epoch with more than two steps
(`:273-287`). A run too short for that says so at its end.

Data-parallel (`parallel/`): every rank runs this loop on its data shard of
the global batches (`data/loader.py`), and cfg.MESH_SHAPE must be a mesh
with a `data` axis that spans the process group (`mesh.check_training_mesh`,
which forms its data groups); the ranks of its other axes replicate their
shard's work, so the global batch and the numbers are the JAX run's on the
same mesh, with no speed-up from the replicas. Each rank draws the global
batch's noise from the epoch's generator and keeps its rows
(`train/steps.py`), so the draws do not depend on the rank count. The
seq-consistency shuffle is its host's, as in the JAX package, where one
process a host shuffles the host's whole story batch with
`default_rng([seed, epoch])` (`cpcsv_tpu/train/trainer.py:127-134`), a
story's partner drawn among all of them: the story loader reads the data
shards of the rank's host (`data.loader.training_loaders`), every rank of
the host shuffles that batch with the same generator, one batch after
another as the JAX trainer does (within a chunk too), and keeps its own
rows of the result. A host is a command that the user started (a
torchrun node), so a one-command run on W cards shuffles as the JAX
package's one process over its W devices, and ranks started by hand on
the CPU as hosts of one rank each. Rank 0
alone writes the run directory: `setting.yml` and the sources, the logger,
the sample grids, the checkpoints (`train/checkpoint.py`; every rank
restores), the profile trace. The in-training FID/FSD runs on rank 0 over
the whole test set, as the JAX hook scores it, writing the real side's
`.cache` file, and the other ranks receive its scores. A rank runs on its
own card, named by index (the batch prefetch thread copies there), and
says how many ranks and hosts train, at which global batches and on
which card each rank runs.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.data.loader import DataLoader, WrapAroundIterator, global_batches
from cpcsv_tpu_torch.data.prefetch import BatchCopier, device_prefetch, stack_batches
from cpcsv_tpu_torch.device import resolve_device
from cpcsv_tpu_torch.evaluation import sampling
from cpcsv_tpu_torch.evaluation.datasets import StoryGANSSIMDataset
from cpcsv_tpu_torch.evaluation.drivers import (
    evaluate_fid_fsd_in_memory,
    make_in_memory_extractors,
)
from cpcsv_tpu_torch.evaluation.ssim import ssim_score
from cpcsv_tpu_torch.losses.shuffle import create_random_shuffle
from cpcsv_tpu_torch.parallel.distributed import host_group, host_info, process_info
from cpcsv_tpu_torch.parallel.mesh import (
    broadcast_from_rank0,
    check_training_mesh,
    host_shards,
    mesh_size,
)
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.train.state import TrainState, check_replicas, create_train_state
from cpcsv_tpu_torch.train.steps import captures_chunks, make_scan_steps, make_train_steps
from cpcsv_tpu_torch.utils.image import save_image_results, save_story_results
from cpcsv_tpu_torch.utils.logging import MetricsLogger
from cpcsv_tpu_torch.utils.profiling import profile_env_dir, start_trace, stop_trace

EPOCH_STEPS_SPAN = "GANTrainer.epoch_steps"  # a torch.profiler range around an epoch's steps
PROFILE_STEPS = (2, 5)  # CPCSV_PROFILE_DIR at K = 1: the first and the last step traced
PROFILE_CHUNK = 1  # CPCSV_PROFILE_DIR at K > 1: the chunk of an epoch traced


def lr_at_epoch(base_lr: float, epoch: int, decay_step: int) -> float:
    """Reference schedule (trainer.py:447-456): at the end of each epoch e > 0
    with e % current_step == 0, halve the LR and double current_step (20, 40,
    80, ...). So epoch == decay_step still trains at the pre-decay LR; the
    halved LR first applies at decay_step + 1."""
    lr = base_lr
    step = decay_step
    for e in range(1, epoch):
        if step > 0 and e % step == 0:
            lr *= 0.5
            step *= 2
    return lr


def epoch_seed(seed: int, epoch: int, stream: int) -> int:
    """A 64-bit seed for one of an epoch's random streams (0: the steps'
    noise, 1: the sample grid), from (seed, epoch, stream) alone."""
    return int(np.random.SeedSequence([seed, epoch, stream]).generate_state(1, np.uint64)[0])


class _NoLogger:
    """The logger of a rank other than 0: it writes nothing."""

    def add_scalar(self, *_) -> None: ...
    def add_scalars(self, *_) -> None: ...
    def add_image(self, *_) -> None: ...
    def flush(self) -> None: ...


class GANTrainer:
    def __init__(
        self,
        cfg: Config,
        output_dir: str,
        cfg_file: Optional[str] = None,
        continue_ckpt: Optional[str | int] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.layout = check_training_mesh(cfg.MESH_SHAPE)
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # this rank's card by its index: the batch prefetch thread's
            # current card is cuda:0, whatever this thread's is
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.rank = process_info()[0]
        self.output_dir = output_dir
        self.model_dir = os.path.join(output_dir, "Model")
        self.image_dir = os.path.join(output_dir, "Image")
        self.log_dir = os.path.join(output_dir, "log")
        self.test_dir = os.path.join(output_dir, "Test")
        for d in (self.model_dir, self.image_dir, self.log_dir, self.test_dir):
            os.makedirs(d, exist_ok=True)

        # run-dir self-archiving (reference trainer.py:55-61)
        if (cfg_file and self.rank == 0
                and not os.path.exists(os.path.join(output_dir, "setting.yml"))):
            shutil.copyfile(cfg_file, os.path.join(output_dir, "setting.yml"))
            pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            shutil.copyfile(os.path.join(pkg, "models", "generator.py"),
                            os.path.join(output_dir, "generator.py"))
            shutil.copyfile(os.path.abspath(__file__), os.path.join(output_dir, "trainer.py"))

        self.max_epoch = cfg.TRAIN.MAX_EPOCH
        self.snapshot_interval = cfg.TRAIN.SNAPSHOT_INTERVAL
        self.continue_ckpt = continue_ckpt
        self.seed = seed
        self.d_step, self.g_step = make_train_steps(cfg)
        # K > 1: K pairs a chunk, one readback (`steps.make_scan_steps`)
        self.scan_steps = make_scan_steps(cfg) if cfg.SCAN_STEPS > 1 else None
        self.ckpt = CheckpointManager(self.model_dir)
        self.logger = MetricsLogger(self.log_dir) if self.rank == 0 else _NoLogger()
        self._eval_extractors = None  # the in-training FID/FSD's, built at its first call
        self._np_rng = np.random.default_rng(seed)  # reseeded every epoch
        self._story_rows = (0, 1)  # this rank's block of the story batches' blocks (`train`)
        self._eval_rngs: dict[str, torch.Generator] = {}  # `_eval_generator`'s

    def _augment_story_host(self, st_batch: dict) -> dict:
        """With USE_SEQ_CONSISTENCY, the story batch with `shuffled` stories
        and their `order_labels` added, drawn on the host from the epoch's
        numpy generator over the whole batch the story loader gave (its
        host's), then this rank's rows of it (see the module's docstring);
        otherwise the batch as it is."""
        if not self.cfg.USE_SEQ_CONSISTENCY:
            return st_batch
        shuffled, order_labels = create_random_shuffle(st_batch["images"], rng=self._np_rng)
        st_batch = {**st_batch, "shuffled": shuffled, "order_labels": order_labels}
        block, blocks = self._story_rows
        if blocks == 1:
            return st_batch
        n = len(order_labels) // blocks
        return {k: v[block * n:(block + 1) * n] for k, v in st_batch.items()}

    def _host_story_rows(self, storyloader) -> tuple[int, int]:
        """(this rank's block, the blocks) of the story loader's batches:
        with USE_SEQ_CONSISTENCY in a group of several ranks the loader
        must read the data shards of this rank's host (as
        `training_loaders` builds it), or the shuffle would not be the
        host's, and this rank keeps the block of its data shard."""
        if not self.cfg.USE_SEQ_CONSISTENCY:
            return 0, 1
        shards = tuple(getattr(storyloader, "shards", (self.layout.data_index,)))
        if process_info()[1] > 1 and shards != host_shards(self.cfg.MESH_SHAPE):
            raise ValueError(
                f"USE_SEQ_CONSISTENCY: the story loader reads data shards {shards}, not this "
                f"rank's host's {host_shards(self.cfg.MESH_SHAPE)}: the story shuffle is the "
                "host's (build the loaders with data.loader.training_loaders)")
        return shards.index(self.layout.data_index), len(shards)

    def _say_ranks(self, world: int) -> None:
        """Rank 0 prints the ranks, hosts and global batches of a group of
        several ranks, and the card of every rank (its UUID), gathered on
        the host group: every rank calls this."""
        cfg = self.cfg
        card = "cpu"
        if self.device.type == "cuda":
            props = torch.cuda.get_device_properties(self.device)
            card = str(getattr(props, "uuid", f"cuda:{self.device.index}"))
        cards = [None] * world
        dist.all_gather_object(cards, card, group=host_group())
        if self.rank == 0:
            _, hosts, _, per_host = host_info()
            im_bs, st_bs = global_batches(cfg)
            print(f"DATA PARALLEL: {world} ranks on {hosts} host(s) of {per_host}, MESH_SHAPE "
                  f"{cfg.MESH_SHAPE or f'data:{world}'}, global batches IM {im_bs} / ST {st_bs}")
            print("DATA PARALLEL cards: " + ", ".join(f"rank {r} {c}" for r, c in enumerate(cards)))

    # ------------------------------------------------------------------
    def _warm_start_generator(self, state: TrainState) -> None:
        """NET_G: the generator from a port or reference netG_epoch_E.pth
        (reference trainer.py:109-114), its BN statistics included."""
        sd = torch.load(self.cfg.NET_G, map_location="cpu", weights_only=True)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}  # a DataParallel save
        state.gen.load_state_dict(sd, strict=True)
        print("Load netG from:", self.cfg.NET_G)

    def train(self, imageloader: DataLoader, storyloader: DataLoader, testloader=None) -> TrainState:
        cfg = self.cfg
        state = create_train_state(cfg, self.seed, self.device)
        if cfg.NET_G:
            self._warm_start_generator(state)

        start_epoch = 0
        if self.continue_ckpt == "auto":
            # crash-resume after the last completed epoch: resuming at it
            # would train it twice
            last = self.ckpt.last_epoch()
            if last is not None:
                self.ckpt.restore(state)
                check_replicas(state)
                start_epoch = last + 1
                print(f"Auto-resume from epoch {start_epoch}")
        elif self.continue_ckpt:
            # an explicit --continue_ckpt E restarts at E, the checkpointed
            # epoch trained again (the reference's semantics, trainer.py:232-235)
            start_epoch = int(self.continue_ckpt)
            self.ckpt.restore(state, epoch=start_epoch)
            check_replicas(state)
            print(f"Continue training from epoch {start_epoch}")

        image_iter = WrapAroundIterator(imageloader)
        copier = BatchCopier(self.device)
        num_step = len(storyloader)
        c_time = time.time()
        print(f"LR DECAY EPOCH: {cfg.TRAIN.LR_DECAY_EPOCH}")
        world = process_info()[1]
        if world > 1:
            self._say_ranks(world)
        self._story_rows = self._host_story_rows(storyloader)
        if self.scan_steps is not None:
            way = ("replayed as a CUDA graph of the D+G pair" if captures_chunks(self.device)
                   else "run eagerly")
            print(f"SCAN_STEPS {cfg.SCAN_STEPS}: each chunk's pairs {way}")
        profile_dir = profile_env_dir() if self.rank == 0 else None  # armed until one trace
        # the steps' noise: one generator, reseeded every epoch (a captured
        # pair draws from the generator it was captured with)
        rng = torch.Generator(device=self.device)

        for epoch in range(start_epoch, self.max_epoch):
            start_t = time.time()
            rng.manual_seed(epoch_seed(self.seed, epoch, 0))
            self._np_rng = np.random.default_rng([self.seed, epoch])
            for loader in (storyloader, imageloader):
                if hasattr(loader, "set_epoch"):
                    loader.set_epoch(epoch)
            lr_g = lr_at_epoch(cfg.TRAIN.GENERATOR_LR, epoch, cfg.TRAIN.LR_DECAY_EPOCH)
            lr_d = lr_at_epoch(cfg.TRAIN.DISCRIMINATOR_LR, epoch, cfg.TRAIN.LR_DECAY_EPOCH)
            stats: dict = {}

            def paired_batches():
                for st_host in storyloader:
                    yield st_host, next(image_iter)

            def log_row(row: dict, i: int) -> None:
                """Reference cadence: story-D scalars every step
                (trainer.py:357-360), everything else every 20 (:432-435)."""
                stats.update(row)
                step = i + num_step * epoch
                for tag in ("st_D/loss", "st_D/real", "st_D/fake", "st_D/order"):
                    if tag in row:
                        self.logger.add_scalar(tag, row[tag], step)
                if i % 20 == 0:
                    self.logger.add_scalars(
                        {k: v for k, v in stats.items() if not k.startswith("st_D/")}, step)

            run_epoch = self._pairs if self.scan_steps is None else self._chunks
            with record_function(EPOCH_STEPS_SPAN):
                last_st_host, profile_dir = run_epoch(state, rng, paired_batches(), copier,
                                                      lr_d, lr_g, log_row, profile_dir)

            # ---- epoch sample grid (reference trainer.py:437-444)
            if last_st_host is not None and self.rank == 0:
                self._log_epoch_samples(state, epoch, last_st_host)

            self.logger.add_scalar("learning/generator", lr_g, epoch)
            self.logger.add_scalar("learning/st_discriminator", lr_d, epoch)
            self.logger.add_scalar("learning/im_discriminator", lr_d, epoch)

            if cfg.EVALUATE_FID_SCORE and testloader is not None:
                self.calculate_vfid(state, epoch, testloader)

            epoch_time = time.time() - start_t
            total_mins = int((time.time() - c_time) / 60)
            frames_per_step = (cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN
                               + cfg.TRAIN.IM_BATCH_SIZE) * mesh_size(cfg.MESH_SHAPE)
            fps = num_step * frames_per_step / max(epoch_time, 1e-9)
            self.logger.add_scalar("perf/frames_per_sec", fps, epoch)
            self.logger.add_scalar("perf/epoch_seconds", epoch_time, epoch)
            print(f"----[{epoch}/{self.max_epoch}] epoch time {epoch_time:.1f}s "
                  f"({fps:.0f} frames/s), total {total_mins} mins----")

            if epoch % self.snapshot_interval == 0:
                self.ckpt.save(state, epoch)
        # the final save keeps the reference's name netG_epoch_{MAX_EPOCH} and
        # records the last completed epoch for auto-resume
        self.ckpt.save(state, self.max_epoch, completed=self.max_epoch - 1)
        if profile_dir:
            what = (f"more than {PROFILE_STEPS[0]} steps" if self.scan_steps is None
                    else f"a chunk {PROFILE_CHUNK + 1} of {cfg.SCAN_STEPS} steps")
            print(f"WARNING: CPCSV_PROFILE_DIR was set but no epoch had {what} to trace")
        self.logger.flush()
        return state

    # ------------------------------------------------------------------
    def _pairs(self, state, rng, batches, copier, lr_d, lr_g, log_row, profile_dir):
        """An epoch one D+G pair at a time (SCAN_STEPS <= 1), each pair's
        metrics read back in one copy; traces steps PROFILE_STEPS into
        `profile_dir` if it is set. Returns (the last story batch, the
        profile directory, None once traced)."""
        def put(pair):  # on the prefetch thread, one batch after another
            st_host = self._augment_story_host(pair[0])  # this rank's rows
            return st_host, copier(st_host), copier(pair[1])

        last_st_host, prof = None, None
        for i, (st_host, st_staged, im_staged) in enumerate(
                device_prefetch(batches, put, depth=2)):
            if profile_dir and i == PROFILE_STEPS[0]:
                prof = start_trace(profile_dir)
            st_batch, im_batch = copier.ready(st_staged), copier.ready(im_staged)
            _, d_metrics = self.d_step(state, rng, st_batch, im_batch, lr_d)
            _, g_metrics = self.g_step(state, rng, st_batch, im_batch, lr_g)
            # one device-to-host copy for all of the pair's scalars
            metrics = {**d_metrics, **g_metrics}
            values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
            log_row(dict(zip(metrics, values.tolist())), i)
            last_st_host = st_host
            if prof is not None and i == PROFILE_STEPS[1]:
                stop_trace(prof)
                prof = profile_dir = None
        if prof is not None:  # the epoch ended inside the traced steps
            stop_trace(prof)
            profile_dir = None
        return last_st_host, profile_dir

    def _chunks(self, state, rng, batches, copier, lr_d, lr_g, log_row, profile_dir):
        """An epoch in chunks of SCAN_STEPS pairs (`cpcsv_tpu/train/trainer.py:296-355`),
        each chunk's metrics read back in one copy; traces the epoch's chunk
        PROFILE_CHUNK, its first warm one, into `profile_dir` if it is set.
        Returns as `_pairs`."""
        K = self.cfg.SCAN_STEPS

        def chunked():
            chunk = []
            for pair in batches:
                if chunk and (pair[0]["images"].shape != chunk[0][0]["images"].shape
                              or pair[1]["images"].shape != chunk[0][1]["images"].shape):
                    yield chunk  # a ragged batch: flush, so that every chunk stacks
                    chunk = []
                chunk.append(pair)
                if len(chunk) == K:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk  # a shorter last chunk

        def put_chunk(chunk):  # on the prefetch thread, one chunk after another
            st_hosts = [self._augment_story_host(st) for st, _ in chunk]  # this rank's rows
            return (st_hosts[-1], copier(stack_batches(st_hosts)),
                    copier(stack_batches([im for _, im in chunk])))

        i, last_st_host = 0, None
        # depth 1: a chunk in flight is already K batches on the card
        for ci, (st_host, st_staged, im_staged) in enumerate(
                device_prefetch(chunked(), put_chunk, depth=1)):
            prof = start_trace(profile_dir) if profile_dir and ci == PROFILE_CHUNK else None
            _, metrics = self.scan_steps(state, rng, copier.ready(st_staged),
                                         copier.ready(im_staged), lr_d, lr_g)
            rows = torch.stack(list(metrics.values()), dim=1).tolist()  # the one readback
            if prof is not None:
                stop_trace(prof)
                profile_dir = None
            for row in rows:
                log_row(dict(zip(metrics, row)), i)
                i += 1
            last_st_host = st_host
        return last_st_host, profile_dir

    # ------------------------------------------------------------------
    def _log_epoch_samples(self, state: TrainState, epoch: int, st_host: dict) -> None:
        """The last story batch through the eval-mode generator
        (`sampling.sample`), with noise of the epoch's own sample stream (the
        steps' stream is not touched)."""
        cfg, gen = self.cfg, state.gen
        generator = self._eval_generator("grid", epoch_seed(self.seed, epoch, 1))
        motion = np.concatenate([st_host["description"], st_host["labels"]], axis=2)
        with self._eval_mode(state):
            image, mask = sampling.sample(
                gen, torch.as_tensor(motion, dtype=torch.float32, device=self.device),
                torch.as_tensor(st_host["description"], dtype=torch.float32, device=self.device),
                seg=cfg.SEGMENT_LEARNING, generator=generator)
        grid = save_story_results(st_host["images"], image.float().cpu().numpy(),
                                  st_host.get("text"), f"{epoch:03d}", self.image_dir)
        self.logger.add_image("pororo", grid, epoch)
        if mask is not None:
            seg = mask.float().cpu().numpy()
            self.logger.add_image("segment", save_image_results(None, seg, cfg.VIDEO_LEN), epoch)

    def _eval_generator(self, stream: str, seed: int) -> torch.Generator:
        """The trainer's one generator of an eval-mode noise stream ("grid",
        "ssim", "vfid"), reseeded to `seed`: its draws are a fresh
        generator's with that seed, and a sampler graph captured on it in
        one epoch replays in the next (a graph registers the generator
        object)."""
        if stream not in self._eval_rngs:
            self._eval_rngs[stream] = torch.Generator(device=self.device)
        return self._eval_rngs[stream].manual_seed(seed)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _eval_mode(self, state: TrainState):
        """The generator in eval mode while the block runs, in train mode after."""
        state.gen.eval()
        try:
            yield state.gen
        finally:
            state.gen.train()

    def calculate_ssim(self, state: TrainState, epoch: int, testloader) -> float:
        """SSIM of the test stories regenerated by the eval-mode generator,
        noise seeded 5678 + epoch, logged as Evaluation/ssim (reference
        trainer.py:176-185, whose call is commented out at :472: called on
        demand, not by `train`). Computed on rank 0, sent to the others."""
        value = None
        if self.rank == 0:
            generator = self._eval_generator("ssim", 5678 + epoch)
            with self._eval_mode(state) as gen:
                ds = StoryGANSSIMDataset(gen, testloader.dataset, generator,
                                         text_dim=self.cfg.TEXT.DIMENSION)
                value = ssim_score((ds[i] for i in range(len(ds))), device=self.device)
        value = broadcast_from_rank0(value)
        self.logger.add_scalar("Evaluation/ssim", value, epoch)
        return value

    def calculate_vfid(self, state: TrainState, epoch: int, testloader) -> dict:
        """The epoch's FID and FSD over the test set, the eval-mode generator's
        noise seeded 1234 + epoch (`drivers.evaluate_fid_fsd_in_memory`),
        logged as Evaluation/vfid and Evaluation/fid. Computed on rank 0 (the
        only rank that writes the real side's .cache files), sent to the
        others, which wait for it on the host."""
        scores = None
        if self.rank == 0:
            if self._eval_extractors is None:
                self._eval_extractors = make_in_memory_extractors(self.device)
            generator = self._eval_generator("vfid", 1234 + epoch)
            with self._eval_mode(state) as gen:
                # the JAX trainer passes its training mesh; a port trainer is
                # one process on one card (a multi-GPU run is a process a card),
                # so the hook generates on that card, unsplit
                scores = evaluate_fid_fsd_in_memory(self.cfg, gen, testloader, generator,
                                                    extractors=self._eval_extractors)
        scores = broadcast_from_rank0(scores)
        self.logger.add_scalar("Evaluation/vfid", scores["fsd"], epoch)
        self.logger.add_scalar("Evaluation/fid", scores["fid"], epoch)
        return scores
