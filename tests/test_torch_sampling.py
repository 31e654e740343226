"""Eval-mode story generation through one sampler (`evaluation/sampling.py`),
the port's counterpart of the JAX package's jitted samplers: every call site
routes through it; on the CPU it runs eagerly, bit for bit a direct
`sample_videos`; its key follows what the forward reads; its cache stays
bounded; the parameters and buffers a graph reads stay in place across a
snapshot load and a D+G step; the trainer's kept generators draw what fresh
ones did. On a card (`cuda`-marked, skipped here): graphed calls against
eager ones bit for bit, calls split over the cards (or one card listed
twice) against one-device calls, and a failed capture raises.

No JAX here, so that the `cuda` tests run where JAX is absent:

    python -m pytest --noconftest tests/test_torch_sampling.py -m cuda
"""

import dataclasses
import gc
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch

from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
from cpcsv_tpu_torch.evaluation import drivers, sampling
from cpcsv_tpu_torch.evaluation.datasets import StoryGANSSIMDataset
from cpcsv_tpu_torch.evaluation.ssim import ssim_score
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.ops.blocks import FUSED_UPSAMPLE
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.train.graphs import ShapeGraphs
from cpcsv_tpu_torch.train.state import create_train_state
from cpcsv_tpu_torch.train.steps import make_train_steps
from cpcsv_tpu_torch.train.trainer import GANTrainer, epoch_seed
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The trainer's logger writes metrics.jsonl only (`tests/test_torch_cli.py`)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        yield


def tiny(name: str = "final.yml", **updates):
    cfg = config_from_file(name).with_updates(GAN=TINY, **updates)
    return cfg.with_updates(TRAIN=dataclasses.replace(cfg.TRAIN, IM_BATCH_SIZE=4,
                                                      ST_BATCH_SIZE=2))


def motion_content(cfg, stories: int, seed: int = 0, device="cpu"):
    batch = next(story_batches(SyntheticStoryDataset(stories, seed=seed), stories))
    return tuple(torch.from_numpy(a).to(device)
                 for a in drivers._batch_motion_content(cfg, batch))


def seeded_net(cfg, device="cpu", seed=0):
    """An eval-mode generator of random weights, BN statistics moved off the
    identity, from `seed`."""
    torch.manual_seed(seed)
    net = generator_from_config(cfg)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    return net.to(device).eval()


class StandIn:
    """A 12-d extractor: a fixed projection of 4 x 4 pooled colour means (of
    a story's mean frame)."""

    random_init, fingerprint, backbone = True, "sampling-stand-in", "stand-in"

    def __init__(self):
        self.w = np.random.default_rng(3).standard_normal((3 * 16, 12)).astype(np.float32)

    def __call__(self, x):
        x = np.asarray(x, np.float32)
        if x.ndim == 5:
            x = x.mean(axis=1)
        pooled = x.reshape(x.shape[0], 4, 16, 4, 16, 3).mean(axis=(2, 4))
        return np.tanh(pooled.reshape(x.shape[0], -1) @ self.w)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny final.yml trainer on the CPU, its state, loaders and a saved
    generator snapshot."""
    from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders

    root = tmp_path_factory.mktemp("sampling")
    cfg = tiny()
    trainer = GANTrainer(cfg, str(root / "run"), device="cpu")
    state = create_train_state(cfg, 0, "cpu")
    trainer._eval_extractors = (StandIn(), StandIn())
    CheckpointManager(trainer.model_dir).save_generator(state.gen.state_dict(), 0)
    loaders = synthetic_loaders(cfg, 4, seed=0)
    st_host = next(iter(loaders[1]))
    return types.SimpleNamespace(cfg=cfg, trainer=trainer, state=state, loaders=loaders,
                                 st_host=st_host, root=root)


@pytest.fixture
def spy(monkeypatch):
    """Every call of `sampling.sample` as (net, B, seg, generator, image),
    passed on to the real one with its eval mesh."""
    calls, real = [], sampling.sample

    def spying(net_g, motion, content, seg=False, generator=None, mesh=None):
        out = real(net_g, motion, content, seg=seg, generator=generator, mesh=mesh)
        calls.append((net_g, motion.shape[0], seg, generator, out[0].clone()))
        return out

    monkeypatch.setattr(sampling, "sample", spying)
    return calls


SITES = ("sample_videos_np", "generate_story", "eval_ssim", "evaluate_fid_fsd_in_memory",
         "epoch_grid", "calculate_ssim", "calculate_vfid")


@pytest.mark.parametrize("site", SITES)
def test_every_call_site_routes_through_the_sampler(site, run, spy, tmp_path, monkeypatch):
    """Each of the JAX package's jitted generation calls has its port call
    site go through `sampling.sample`, with the net and generator it owns."""
    monkeypatch.chdir(tmp_path)  # the hook's .cache/
    cfg, trainer, state = run.cfg, run.trainer, run.state
    test = run.loaders[2]
    infer = drivers.Infer(cfg, device="cpu", output_dir=str(run.root / "run"), load_ckpt=0)
    n_test = len(test.dataset)
    if site == "sample_videos_np":
        infer.sample_videos_np(run.st_host, seg=True)
        expected = [(infer.net_g, 2, True, infer.generator)]
    elif site == "generate_story":
        infer.generate_story(story_batches(SyntheticStoryDataset(3), 2), "walk")
        expected = [(infer.net_g, 2, False, infer.generator), (infer.net_g, 1, False,
                                                               infer.generator)]
    elif site == "eval_ssim":
        infer.eval_ssim(test.dataset)
        expected = [(infer.net_g, n_test, False, infer.generator)]
    elif site == "evaluate_fid_fsd_in_memory":
        generator = torch.Generator().manual_seed(1)
        drivers.evaluate_fid_fsd_in_memory(cfg, infer.net_g, test, generator,
                                           extractors=(StandIn(), StandIn()))
        expected = [(infer.net_g, n_test, False, generator)]
    elif site == "epoch_grid":
        trainer._log_epoch_samples(state, 0, run.st_host)
        expected = [(state.gen, 2, cfg.SEGMENT_LEARNING, trainer._eval_rngs["grid"])]
    elif site == "calculate_ssim":
        trainer.calculate_ssim(state, 0, test)
        expected = [(state.gen, n_test, False, trainer._eval_rngs["ssim"])]
    else:
        trainer.calculate_vfid(state, 0, test)
        expected = [(state.gen, n_test, False, trainer._eval_rngs["vfid"])]
    got = [c[:4] for c in spy]
    assert len(got) == len(expected)
    for g, e in zip(got, expected):
        assert g[0] is e[0] and g[1:3] == e[1:3] and g[3] is e[3]


@pytest.mark.parametrize("name,seg", [("final.yml", False), ("cascade.yml", True)])
def test_cpu_sampler_is_eager_sample_videos_bit_for_bit(name, seg):
    """On the CPU the sampler is `sample_videos` run eagerly: the same bits
    under the same generator state, which it advances alike; no cache."""
    cfg = tiny(name)
    net = seeded_net(cfg)
    motion, content = motion_content(cfg, 3)
    gen = torch.Generator().manual_seed(4)
    image, mask = sampling.sample(net, motion, content, seg=seg, generator=gen)
    after = gen.get_state()
    gen.manual_seed(4)
    with torch.no_grad():
        ref = net.sample_videos(motion, content, seg=seg, generator=gen)
    assert torch.equal(image, ref.image) and torch.equal(gen.get_state(), after)
    assert (mask is None) == (not seg) and (not seg or torch.equal(mask, ref.seg))
    assert net not in sampling._caches


CHANGES = ("stories", "frames dtype", "seg", "compute dtype", "lowering", "mode",
           "generator", "cudnn deterministic")


@pytest.mark.parametrize("change", CHANGES)
def test_key_follows_what_the_forward_reads(change, monkeypatch):
    """The key of a call is stable, and changes with each thing the forward
    reads besides the tensors' values."""
    cfg = tiny()
    net = seeded_net(cfg)
    motion, content = motion_content(cfg, 2)
    gen = torch.Generator()
    key = sampling.sample_key(net, motion, content, False, gen)
    assert sampling.sample_key(net, motion.clone(), content.clone(), False, gen) == key
    args = [net, motion, content, False, gen]
    if change == "stories":
        args[1:3] = motion_content(cfg, 3)
    elif change == "frames dtype":
        args[1] = motion.double()
    elif change == "seg":
        args[3] = True
    elif change == "compute dtype":
        args[0] = generator_from_config(tiny("throughput.yml"))
    elif change == "lowering":
        upblocks = sampling.cache_of(net).upblocks
        assert len(upblocks) == 8
        upblocks[-1].fused = next(f for f in FUSED_UPSAMPLE if f != upblocks[-1].fused)
    elif change == "mode":
        net.train()
    elif change == "generator":
        args[4] = torch.Generator()
    else:
        monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                            not torch.backends.cudnn.deterministic)
    assert sampling.sample_key(*args) != key


def test_cache_stays_bounded_and_goes_with_its_net():
    """At most MAX_GRAPHS graphs a net, the least recently used dropped; a
    graph is found only for its own generator; the cache lives as long as
    its net."""
    graphs = ShapeGraphs(sampling.MAX_GRAPHS, shared_pool=True)
    gens = [torch.Generator(), torch.Generator()]
    for k in range(sampling.MAX_GRAPHS + 3):
        graphs.add(types.SimpleNamespace(key=("k", k), generator=gens[0]))
        if k >= 2:
            assert graphs.get(("k", 2), gens[0]) is not None  # kept: used last
        assert len(graphs.graphs) <= sampling.MAX_GRAPHS
    assert ("k", 2) in graphs.graphs and ("k", 0) not in graphs.graphs
    assert graphs.get(("k", 2), gens[1]) is None
    graphs.add(types.SimpleNamespace(key=("k", 2), generator=gens[1]))  # replaces
    assert len(graphs.graphs) == sampling.MAX_GRAPHS
    assert graphs.get(("k", 2), gens[1]) is not None
    net = seeded_net(tiny())
    assert sampling.cache_of(net).graphs.max_graphs == sampling.MAX_GRAPHS
    assert sampling.cache_of(net) is sampling.cache_of(net)
    held = len(sampling._caches)
    del net
    gc.collect()
    assert len(sampling._caches) == held - 1


def _pointers(net) -> dict:
    return {name: t.data_ptr() for name, t in [*net.named_parameters(), *net.named_buffers()]}


def test_parameters_and_buffers_stay_in_place(run, tmp_path):
    """A graph reads the generator's parameters and BN buffers where they
    are: `Infer.load_epoch` and a D+G step write them in place."""
    cfg = run.cfg
    other = create_train_state(cfg, 1, "cpu")
    manager = CheckpointManager(str(tmp_path / "Model"))
    manager.save_generator(run.state.gen.state_dict(), 0)
    manager.save_generator(other.gen.state_dict(), 1)
    infer = drivers.Infer(cfg, device="cpu", output_dir=str(tmp_path), load_ckpt=0)
    before = _pointers(infer.net_g)
    w0 = infer.net_g.fc[0].weight.clone()
    infer.load_epoch(1)
    assert _pointers(infer.net_g) == before
    assert not torch.equal(infer.net_g.fc[0].weight, w0)

    state = create_train_state(cfg, 2, "cpu")
    before = _pointers(state.gen)
    mean0 = state.gen.fc[1].running_mean.clone()
    d_step, g_step = make_train_steps(cfg)
    st, im = run.st_host, next(iter(run.loaders[0]))
    rng = torch.Generator().manual_seed(0)
    d_step(state, rng, st, im, 4e-4)
    g_step(state, rng, st, im, 1e-4)
    assert _pointers(state.gen) == before
    assert not torch.equal(state.gen.fc[1].running_mean, mean0)


@pytest.mark.parametrize("stream", ("grid", "ssim", "vfid"))
def test_trainer_kept_generators_draw_as_fresh_ones(stream, run, spy, tmp_path, monkeypatch):
    """The trainer keeps one generator a stream and reseeds it each epoch:
    epoch 1 after epoch 0 gives the grid, SSIM and FID/FSD that a fresh
    generator seeded for epoch 1 gives, as the trainer did before it kept
    them."""
    monkeypatch.chdir(tmp_path)
    cfg, trainer, state = run.cfg, run.trainer, run.state
    test = run.loaders[2]
    gen = state.gen
    if stream == "grid":
        for epoch in (0, 1):
            trainer._log_epoch_samples(state, epoch, run.st_host)
        motion, content = drivers._batch_motion_content(cfg, run.st_host)
        fresh = torch.Generator().manual_seed(epoch_seed(trainer.seed, 1, 1))
        with torch.no_grad():
            gen.eval()
            ref = gen.sample_videos(torch.from_numpy(motion), torch.from_numpy(content),
                                    seg=cfg.SEGMENT_LEARNING, generator=fresh).image
            gen.train()
        assert torch.equal(spy[-1][4], ref)
    elif stream == "ssim":
        trainer.calculate_ssim(state, 0, test)
        got = trainer.calculate_ssim(state, 1, test)
        gen.eval()
        ds = StoryGANSSIMDataset(gen, test.dataset, torch.Generator().manual_seed(5678 + 1),
                                 text_dim=cfg.TEXT.DIMENSION)
        ref = ssim_score((ds[i] for i in range(len(ds))), device="cpu")
        gen.train()
        assert got == ref
    else:
        trainer.calculate_vfid(state, 0, test)
        got = trainer.calculate_vfid(state, 1, test)
        gen.eval()
        ref = drivers.evaluate_fid_fsd_in_memory(cfg, gen, test,
                                                 torch.Generator().manual_seed(1234 + 1),
                                                 extractors=trainer._eval_extractors)
        gen.train()
        assert got == ref
    assert gen.training


# --------------------------------------------------------------------- card
def _count_dfn():
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    return dfn_cuda.launches["dfn_forward"]


def _eager(net, motion, content, seg, gen):
    from cpcsv_tpu_torch.device import float32_math

    with torch.no_grad(), float32_math():
        out = net.sample_videos(motion, content, seg=seg, generator=gen)
    return out.image.clone(), None if out.seg is None else out.seg.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("final.yml", "cascade.yml", "throughput.yml",
                                  "procedural.yml"))
def test_cuda_graphed_calls_equal_eager_calls(name, tmp_path):
    """On the card, v1 and cascade at float32 and bfloat16: two shapes and
    a ragged one, seg on and off, through `Infer`, a snapshot loaded between
    calls and a lowering flipped: every call after the first at a key
    replays, and its frames (and masks) equal an eager `sample_videos`
    under the same generator state bit for bit, which both advance alike;
    a rewound generator reaches the replay; one DFN launch a call. Under
    cudnn.deterministic: at the default flags the `deconv` lowering's
    transposed convs sum in varying order, and two eager calls differ in
    their last bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _graphed_calls_equal_eager_calls(name, tmp_path)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _graphed_calls_equal_eager_calls(name, tmp_path):
    dev = torch.device("cuda")
    cfg = config_from_file(name).with_updates(GAN=TINY)
    manager = CheckpointManager(str(tmp_path / "Model"))
    for epoch in (0, 1):
        manager.save_generator(seeded_net(cfg, seed=epoch).state_dict(), epoch)
    infer = drivers.Infer(cfg, device=dev, output_dir=str(tmp_path), load_ckpt=0, seed=3)
    net, gen = infer.net_g, infer.generator
    cache = sampling.cache_of(net)
    eager, captured = sampling.totals["eager"], sampling.totals["captured"]
    for epoch, lowering in ((0, None), (1, None), (1, "flip")):
        if epoch == 1:
            infer.load_epoch(1)
        if lowering:
            block = cache.upblocks[0]
            block.fused = next(f for f in FUSED_UPSAMPLE if f != block.fused)
        for stories, seg in ((4, False), (4, True), (8, False), (3, False)):
            motion, content = motion_content(cfg, stories, seed=stories, device=dev)
            for _ in range(2):
                replays, dfn = sampling.totals["replayed"], _count_dfn()
                key = sampling.sample_key(net, motion, content, seg, gen)
                fresh = key not in cache.graphs.graphs
                rng = gen.get_state()
                image, mask = sampling.sample(net, motion, content, seg=seg, generator=gen)
                image, mask = image.clone(), None if mask is None else mask.clone()
                after = gen.get_state()
                gen.set_state(rng)
                ref_image, ref_mask = _eager(net, motion, content, seg, gen)
                assert torch.equal(gen.get_state(), after)
                assert torch.equal(image, ref_image), (name, epoch, lowering, stories, seg)
                assert (mask is None) == (ref_mask is None)
                assert mask is None or torch.equal(mask, ref_mask)
                gen.set_state(rng)  # a rewind reaches the replay
                again, _ = sampling.sample(net, motion, content, seg=seg, generator=gen)
                assert torch.equal(again, image)
                assert sampling.totals["replayed"] - replays == (1 if fresh else 2)
                assert _count_dfn() - dfn == 2 + 1  # the two calls and the eager one
    video, _ = infer.sample_videos_np(next(story_batches(SyntheticStoryDataset(4, seed=4), 4)))
    assert video.dtype == np.float32 and np.isfinite(video).all()
    assert len(cache.graphs.graphs) <= sampling.MAX_GRAPHS
    # 4 keys, captured again after the flip only (the snapshot replays)
    assert sampling.totals["eager"] - eager == sampling.totals["captured"] - captured == 8


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("final.yml", "procedural.yml"))
def test_cuda_sharded_calls_equal_one_device(name):
    """On the cards (every local one, or cuda:0 listed twice on a host of
    one), float32 and bfloat16, under cudnn.deterministic: a call split over
    the eval mesh (`parallel/mesh.py`) gives, in each block, the bits of an
    eager one-device call on its rows and its slice of the batch's noise,
    and in all within 1e-4 (bfloat16 0.03125) of the unsplit call, with the
    generator advanced alike; a ragged batch runs whole; each call after a
    key's first replays on every device; one DFN launch a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.parallel.mesh import make_eval_mesh

    count = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(count)] if count > 1 else ["cuda:0"] * 2
    mesh = make_eval_mesh(devices=devices)
    shards = len(mesh)
    cfg = config_from_file(name).with_updates(GAN=TINY)
    net = seeded_net(cfg, "cuda:0")
    gen = torch.Generator(device="cuda:0").manual_seed(3)
    bound = 1e-4 if net.dtype is None else 0.03125
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for call, stories in enumerate((2 * shards, 2 * shards, 2 * shards + 1)):
            motion, content = motion_content(cfg, stories, seed=stories, device="cuda:0")
            rng = gen.get_state()
            whole, _ = _eager(net, motion, content, False, gen)
            gen.set_state(rng)
            noise = net.draw_noise(stories, cfg.VIDEO_LEN, gen)
            gen.set_state(rng)
            dfn, replays = _count_dfn(), sampling.totals["replayed"]
            image, _ = sampling.sample(net, motion, content, generator=gen, mesh=mesh)
            split = stories % shards == 0
            assert _count_dfn() - dfn == (shards if split else 1)
            assert image.device == motion.device and image.shape == whole.shape
            after = gen.get_state()
            gen.set_state(rng)
            _eager(net, motion, content, False, gen)
            assert torch.equal(gen.get_state(), after)
            assert float((image.float() - whole.float()).abs().max()) <= bound
            if not split:
                continue
            rows = stories // shards
            for k in range(shards):
                block = slice(k * rows, (k + 1) * rows)
                with torch.no_grad(), float32_math():
                    ref = net.sample_videos(motion[block], content[block],
                                            noise=tuple(n[block] for n in noise)).image
                assert torch.equal(image[block], ref), (name, stories, k)
            assert sampling.totals["replayed"] - replays == (shards if call == 1 else 0)
    finally:
        torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
def test_cuda_a_failed_sampler_capture_raises():
    """No fallback: a forward that reads a value on the host cannot be
    captured, and the call raises instead of running eagerly; no graph is
    kept. (Last in the file: a failed capture may leave the card's stream
    state to the process that made it.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = tiny()
    net = seeded_net(cfg, dev)
    motion, content = motion_content(cfg, 2, device=dev)
    real = net.sample_videos

    def reading(*args, **kwargs):
        out = real(*args, **kwargs)
        out.image.sum().item()  # a host sync: refused while a CUDA graph captures
        return out

    with mock.patch.object(net, "sample_videos", reading), pytest.raises(RuntimeError):
        sampling.sample(net, motion, content, generator=torch.Generator(device=dev))
    assert sampling.cache_of(net).graphs.graphs == {}
