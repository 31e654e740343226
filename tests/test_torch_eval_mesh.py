"""Eval-mode generation split over an eval mesh (`parallel/mesh.py:make_eval_mesh`,
`eval_shards`; `evaluation/sampling.py`), the port's counterpart of the JAX
package's `make_eval_mesh` / `eval_shardings` / `shard_eval_inputs`.

On the CPU the `devices=` seam lists the CPU several times: each row block
runs on a replica of its own, eagerly. Held here:
  * the mesh a MESH_SHAPE resolves to, and the blocks a batch splits into,
    against the JAX package's on the tests' 8 CPU devices;
  * `Infer` split over 4 devices against one device (float32 within the JAX
    test's 2e-6, float64 within 1e-12), the generator's state after the call
    equal; the split frames against the JAX package's split forward;
  * a walk over two snapshots, and `StoryGANDataset` with full and ragged
    chunks, split against one device; the replicas refreshed by a load;
  * TORCH_REPEAT_QUIRK (a cross-sample op) unchanged by the mesh;
  * the CLI's walks over every local device, and none in a process group.
The card's test (each block on a card, or on one card listed twice) is in
`tests/test_torch_sampling.py`.
"""

import functools
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from cpcsv_tpu.parallel import mesh as jax_mesh
from cpcsv_tpu_torch.cli import dispatch
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
from cpcsv_tpu_torch.evaluation import drivers, sampling
from cpcsv_tpu_torch.evaluation.datasets import StoryGANDataset
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.parallel import mesh
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.utils.weights import generator_state_dict_from_jax
from test_torch_generator import TOL, configs, jax_sample, perturb
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)
FOUR = ["cpu"] * 4
# JAX's bound for its data:8 walk against data:1 (tests/test_drivers.py)
F32_ATOL, F64_ATOL = 2e-6, 1e-12
# descriptors of 8 cards, to hold the port's devices against JAX's 8 CPU ids
CARDS = [torch.device("cuda", i) for i in range(8)]


def tiny(name: str = "final.yml", **updates):
    return config_from_file(name).with_updates(GAN=TINY, **updates)


@functools.lru_cache(maxsize=None)
def seeded_state(name: str, seed: int = 0) -> dict:
    """A generator's state of random weights, BN statistics moved off the
    identity, from `seed`."""
    torch.manual_seed(seed)
    net = generator_from_config(tiny(name))
    with torch.no_grad():
        for key, buf in net.named_buffers():
            if key.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
            elif key.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    return net.state_dict()


def stories(n: int, seed: int = 0):
    return next(story_batches(SyntheticStoryDataset(n, seed=seed), n))


@pytest.fixture
def blocks(monkeypatch):
    """The rows of every one-device call the sampler makes, in order."""
    calls, real = [], sampling._sample

    def spying(net_g, inputs, seg, generator):
        calls.append(inputs[0].shape[0])
        return real(net_g, inputs, seg, generator)

    monkeypatch.setattr(sampling, "_sample", spying)
    return calls


# ------------------------------------------------------------------- the mesh
MESHES = {  # id: (MESH_SHAPE, batch, processes)
    "all-local": ("", 16, 1),
    "data:4": ("data:4", 8, 1),
    "oversized": ("data:16", 8, 1),
    "model-axis": ("data:4,model:2", 4, 1),
    "data-second": ("model:2,data:4", 12, 1),
    "no-data-axis": ("replica:8", 8, 1),
    "ragged": ("data:4", 6, 1),
    "process-group": ("", 16, 2),
}


@pytest.mark.parametrize("case", MESHES)
def test_eval_mesh_resolves_as_jax(case, monkeypatch):
    """The port's eval mesh over 8 devices against the JAX package's over its
    8 CPU devices: the JAX mesh's axes are MESH_SHAPE's as the port parses
    it (all 8 on `data` for "" and for an oversized mesh), the blocks a batch
    splits into (the data extent, or 1 where `eval_shardings` declines),
    each block's device (the first of its data row), and the warning of an
    oversized mesh, word for word."""
    mesh_shape, batch, processes = MESHES[case]
    monkeypatch.setattr(jax, "process_count", lambda: processes)
    monkeypatch.setattr(mesh, "process_info", lambda: (0, processes))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = jax_mesh.make_eval_mesh(mesh_shape)
        ours = mesh.make_eval_mesh(mesh_shape, devices=CARDS)
    messages = [str(w.message) for w in caught]
    assert len(messages) == (2 if case == "oversized" else 0)
    assert len(set(messages)) <= 1
    every = (("data", len(CARDS)),)
    asked = every if case == "oversized" else tuple(mesh.parse_mesh_shape(mesh_shape)) or every
    assert tuple(ref.shape.items()) == asked
    names = list(ref.axis_names)
    if "data" in names:
        k = names.index("data")
        row = ref.devices[tuple(slice(None) if i == k else 0 for i in range(len(names)))]
    else:
        row = ref.devices.reshape(-1)[:1]
    assert [d.index for d in ours] == [d.id for d in row]
    sharding, _ = jax_mesh.eval_shardings(ref, batch)
    expected = 1 if sharding is None else dict(ref.shape)["data"]
    assert mesh.eval_shards(ours, batch) == expected
    assert mesh.eval_shards(None, batch) == 1


def test_local_devices_are_every_card_of_an_index_less_cuda(monkeypatch):
    """"cuda" spans the host's cards, as `jax.devices()`; a named card or the
    CPU is a mesh of itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.local_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert mesh.local_devices("cuda:1") == [torch.device("cuda", 1)]
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    assert mesh.make_eval_mesh("", "cuda") == tuple(mesh.local_devices("cuda"))


# ----------------------------------------------------------- sharded = one device
@pytest.mark.parametrize("seg", [False, True], ids=["frames", "seg"])
@pytest.mark.parametrize("name", ["final.yml", "cascade.yml"])
def test_sharded_infer_equals_one_device(name, seg, blocks):
    """`Infer` over 4 devices against one: 4 blocks of 2 stories, the frames
    (and masks) within the JAX package's bound, the generator's state after
    the call that of one call."""
    cfg = tiny(name)
    one = drivers.Infer(cfg, seeded_state(name), device="cpu", seed=3)
    four = drivers.Infer(cfg, seeded_state(name), device="cpu", seed=3, devices=FOUR)
    batch = stories(8, seed=1)
    ref = one.sample_videos_np(batch, seg=seg)
    del blocks[:]
    got = four.sample_videos_np(batch, seg=seg)
    assert blocks == [2, 2, 2, 2]
    for a, b in zip(got, ref):
        assert (a is None) == (b is None) == (not seg and b is None)
        if b is not None:
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=F32_ATOL)
    assert torch.equal(four.generator.get_state(), one.generator.get_state())


@pytest.mark.parametrize("name", ["final.yml", "cascade.yml"])
def test_sharded_sampler_equals_one_device_in_float64(name, blocks):
    """The same in float64, where only the summation orders of the blocks'
    smaller matmuls can differ: within 1e-12."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        net = generator_from_config(tiny(name))
        net.load_state_dict(seeded_state(name))
        net = net.double().eval()
        motion, content = (torch.from_numpy(a).double()
                           for a in drivers._batch_motion_content(tiny(name), stories(8, 2)))
        g1, g4 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        ref = sampling.sample(net, motion, content, seg=True, generator=g1)
        got = sampling.sample(net, motion, content, seg=True, generator=g4,
                              mesh=mesh.make_eval_mesh(devices=FOUR))
    finally:
        torch.set_default_dtype(default)
    assert blocks == [8, 2, 2, 2, 2]
    assert ref[0].dtype == got[0].dtype == torch.float64
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= F64_ATOL
    assert torch.equal(g1.get_state(), g4.get_state())


@pytest.mark.parametrize("cascade", [False, True], ids=["v1", "cascade"])
def test_sharded_frames_match_the_jax_split_forward(cascade, blocks):
    """The port split over 4 devices against the JAX package's forward split
    over a data:4 mesh (`shard_eval_inputs`), the same weights (JAX
    variables converted by `utils.weights`) and JAX's noise, drawn for the
    whole batch, injected where the port draws it: within the port's
    sample-vs-JAX tolerance (`tests/test_torch_generator.py`)."""
    jcfg, tcfg = configs(cascade)
    tcfg = tcfg.with_updates(GAN=TINY)
    jcfg = jcfg.with_updates(GAN=type(jcfg.GAN)(**{k: getattr(TINY, k) for k in (
        "CONDITION_DIM", "Z_DIM", "DF_DIM", "GF_DIM", "GF_SEG_DIM")}))
    net = generator_from_config(tcfg)
    from cpcsv_tpu.utils.port_torch import port_generator_state_dict

    variables = perturb(port_generator_state_dict(net.state_dict(), use_segment=True,
                                                  cascade=cascade), seed=30 + cascade)
    net.load_state_dict(generator_state_dict_from_jax(variables, use_segment=True,
                                                      cascade=cascade))
    net.eval()
    rng = np.random.default_rng(40 + cascade)
    motion = rng.standard_normal((4, 5, 365)).astype(np.float32)
    content = rng.standard_normal((4, 5, 356)).astype(np.float32)
    jmesh = jax_mesh.make_eval_mesh("data:4")
    (jm, jc), jvars = jax_mesh.shard_eval_inputs(jmesh, (motion, content), variables, {})
    assert len(jm.sharding.device_set) == 4
    image, seg, draws = jax_sample(jcfg, jvars, "sample_videos", jm, jc, jax.random.PRNGKey(7))
    net.draw_noise = lambda B, T, generator=None: tuple(torch.from_numpy(d) for d in draws)
    got_image, got_seg = sampling.sample(net, torch.from_numpy(motion),
                                         torch.from_numpy(content), seg=True,
                                         mesh=mesh.make_eval_mesh("data:4", devices=FOUR))
    assert blocks == [1, 1, 1, 1]
    np.testing.assert_allclose(got_image.numpy(), image, **TOL)
    np.testing.assert_allclose(got_seg.numpy(), seg, **TOL)


# ------------------------------------------------------------------ the walks
def test_two_snapshot_walk_equals_one_device(tmp_path, blocks):
    """The SSIM walk over two snapshots, newest first, split over 4 devices
    against one: the same scores, every story split; the replicas hold the
    snapshot last loaded, and a state loaded straight into the net reaches
    them at the next call."""
    cfg = tiny()
    manager = CheckpointManager(str(tmp_path / "Model"))
    for epoch in (0, 1):
        manager.save_generator(seeded_state("final.yml", seed=epoch), epoch)
    loader = types.SimpleNamespace(dataset=SyntheticStoryDataset(8, seed=4))
    one = drivers.Infer(cfg, device="cpu", output_dir=str(tmp_path / "one"), seed=2)
    four = drivers.Infer(cfg, device="cpu", output_dir=str(tmp_path / "four"), seed=2,
                         devices=FOUR)
    for infer in (one, four):
        infer.model_dir = str(tmp_path / "Model")
    ref = one.eval_ssim_walk(loader)
    del blocks[:]
    got = four.eval_ssim_walk(loader)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref] == [1, 0]
    assert blocks == [2] * 8
    for a, b in zip(got, ref):
        assert a["ssim"] == pytest.approx(b["ssim"], rel=1e-6)
    replicas = sampling.replicas_of(four.net_g).nets
    assert sorted(replicas) == [1, 2, 3]
    lead = four.net_g.state_dict()
    for replica in replicas.values():
        for key, value in replica.state_dict().items():
            assert torch.equal(value, lead[key]), key
    batch = stories(4, seed=6)
    for infer in (one, four):
        infer.net_g.load_state_dict(seeded_state("final.yml", seed=7))
    np.testing.assert_allclose(four.sample_videos_np(batch)[0], one.sample_videos_np(batch)[0],
                               rtol=0, atol=F32_ATOL)


def test_story_dataset_splits_full_chunks_and_not_a_ragged_tail(blocks):
    """`StoryGANDataset` of 10 stories in chunks of 4 over 4 devices: the two
    full chunks split into blocks of one story, the tail of 2, which the
    data axis does not divide, runs whole; every item as one device's."""
    cfg = tiny("cascade.yml")
    net = generator_from_config(cfg)
    net.load_state_dict(seeded_state("cascade.yml"))
    net.eval()
    ds = SyntheticStoryDataset(10, seed=8)
    one = StoryGANDataset(net, ds, torch.Generator().manual_seed(1), chunk=4)
    four = StoryGANDataset(net, ds, torch.Generator().manual_seed(1), chunk=4,
                           mesh=mesh.make_eval_mesh(devices=FOUR))
    ref = [one[i] for i in range(len(one))]
    del blocks[:]
    got = [four[i] for i in range(len(four))]
    assert blocks == [1, 1, 1, 1, 1, 1, 1, 1, 2]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_ATOL)


def test_repeat_quirk_is_unchanged_by_the_mesh(blocks):
    """TORCH_REPEAT_QUIRK pairs frame (b, t) with the content of sample
    (b·T + t) mod B, a cross-sample op: a net with it runs unsplit, and the
    mesh changes nothing."""
    cfg = tiny(TORCH_REPEAT_QUIRK=True)
    state = seeded_state("final.yml")
    one = drivers.Infer(cfg, state, device="cpu", seed=9)
    four = drivers.Infer(cfg, state, device="cpu", seed=9, devices=FOUR)
    assert four.net_g.torch_repeat_quirk
    batch = stories(8, seed=3)
    ref = one.sample_videos_np(batch)[0]
    del blocks[:]
    got = four.sample_videos_np(batch)[0]
    assert blocks == [8]
    np.testing.assert_array_equal(got, ref)
    plain = drivers.Infer(tiny(), state, device="cpu", seed=9).sample_videos_np(batch)[0]
    assert np.abs(plain - ref).max() > 1e-3  # the quirk does pair otherwise


@pytest.mark.parametrize("processes", [1, 2], ids=["one-process", "process-group"])
def test_cli_walk_spans_every_local_device(processes, tmp_path, monkeypatch, blocks):
    """The CLI's --eval_ssim walk (`cli/dispatch.py`) on a host of 4 devices
    splits each call over all of them under the shipped MESH_SHAPE (""); in
    a process group of 2 it runs whole on its own device."""
    monkeypatch.setattr(mesh, "local_devices", lambda device: [torch.device("cpu")] * 4)
    monkeypatch.setattr(mesh, "process_info", lambda: (0, processes))
    cfg = tiny()
    assert cfg.MESH_SHAPE == ""
    CheckpointManager(str(tmp_path / "Model")).save_generator(seeded_state("final.yml"), 0)
    args = types.SimpleNamespace(eval_fid=False, eval_fvd=False, eval_is=False, eval_ssim=True,
                                 load_ckpt=None, device="cpu")
    loader = types.SimpleNamespace(dataset=SyntheticStoryDataset(4, seed=5))
    rows = dispatch.dispatch(cfg, args, str(tmp_path), None, None, loader)
    assert [r["epoch"] for r in rows] == [0]
    assert blocks == ([1, 1, 1, 1] if processes == 1 else [4])
