"""Training across hosts (`parallel/launch.py`, `parallel/distributed.py`,
`parallel/mesh.py`, `data/loader.py`, `train/trainer.py`), held against the
JAX package's multi-host rules on the CPU.

The JAX package runs one process a host (`cpcsv_tpu/parallel/distributed.py`):
CPCSV_NUM_PROCESSES counts hosts, each process drives every device of its
host, `make_mesh` spans `jax.devices()` in process order, and each process
loads its contiguous 1/process_count slice of every global batch
(`cpcsv_tpu/data/loader.py:43-53`). The port starts one rank a card on
every host, rank host × L + l, and must give the same layout, the same
rows and the same seq-consistency shuffle:

  * (a) the global ranks and world, the mesh rules and the launchers'
    equal-cards rendezvous, against `make_mesh` over 8 CPU devices read as
    2 processes of 4;
  * (b) a rank's loader rows against its rows of the JAX host slice;
  * (c) the shuffle: the ranks' `shuffled` / `order_labels` together are
    `create_random_shuffle` over each host's story batch (this failed
    before the shuffle was the host's: each rank drew over its own rows);
  * (e) a rank that dies on one host ends the other host's command;
  * (f) an eval command under a host environment starts no ranks.
Two host commands of two gloo ranks each against the two-rank run, bit for
bit, are held in `tests/test_torch_parallel.py`
(`test_two_host_commands_write_the_ranks_snapshot`).
"""

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from cpcsv_tpu_torch.cli import dispatch, main_pororo
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data import loader as loader_module
from cpcsv_tpu_torch.data.prefetch import BatchCopier
from cpcsv_tpu_torch.data.synthetic import SyntheticImageDataset, SyntheticStoryDataset
from cpcsv_tpu_torch.parallel import distributed, launch, mesh
from cpcsv_tpu_torch.train import trainer as trainer_module
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
GROUP_VARIABLES = chip_smoke.GROUP_VARIABLES
# `cpcsv_tpu/utils/benchutil.py:shrink_for_cpu`'s widths
TINY = dict(CONDITION_DIM=124, Z_DIM=100, DF_DIM=16, GF_DIM=8, GF_SEG_DIM=32)
CARDS, HOSTS = 4, 2  # the JAX side: 8 CPU devices read as 2 processes of 4


def _as_rank(monkeypatch, rank: int, hosts: int, per_host: int) -> None:
    """This process seen as rank `rank` of hosts × per_host, host-major,
    with no process group: what `process_info` and `host_info` say in
    every module that reads them."""
    world = hosts * per_host
    for module in (distributed, mesh, loader_module, trainer_module):
        monkeypatch.setattr(module, "process_info", lambda: (rank, world), raising=False)
        monkeypatch.setattr(module, "host_info",
                            lambda: (rank // per_host, hosts, rank % per_host, per_host),
                            raising=False)


def _clear_group_env(monkeypatch) -> None:
    for key in GROUP_VARIABLES:
        monkeypatch.delenv(key, raising=False)


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("mesh_shape", ["", "data:8", "data:4,model:2", "model:2,data:4",
                                        "data:2,model:4", "data:4", "data:16"])
def test_ranks_across_hosts_are_jax_make_mesh(mesh_shape):
    """Over 2 hosts of 4 cards, rank h × 4 + l is host h's card l: the
    training world and every rank's mesh coordinates are those of the JAX
    package's `make_mesh(MESH_SHAPE, devices)` over 8 devices, devices
    4h .. 4h + 3 host h's. A mesh of more devices raises in both. A named
    mesh of fewer (data:4) builds in JAX, on devices[:4], host 0's alone:
    host 1 then holds no device of the mesh, and its loader slice, which
    `shard_batch` hands to `make_array_from_process_local_data` on its own
    devices (`cpcsv_tpu/parallel/mesh.py:145-160`,
    `cpcsv_tpu/data/loader.py:43-53`), has nowhere to go: the JAX trainer
    cannot train it, and the port refuses it, naming both counts."""
    import jax

    from cpcsv_tpu.parallel import mesh as jax_mesh

    devices = jax.devices()[:CARDS * HOSTS]
    if mesh_shape == "data:16":
        with pytest.raises(AssertionError, match="mesh needs 16 devices, have 8"):
            jax_mesh.make_mesh(mesh_shape, devices)
        with pytest.raises(ValueError, match=r"needs 16 devices, have 8 \(2 hosts of 4"):
            mesh.training_world(mesh_shape, CARDS, HOSTS, every_card=True)
        return
    ref = jax_mesh.make_mesh(mesh_shape, devices)
    if mesh_shape == "data:4":
        assert {d.id for d in ref.devices.flat} == {0, 1, 2, 3}  # host 0's alone
        with pytest.raises(ValueError, match="takes 4 devices, not every one of the 8"):
            mesh.training_world(mesh_shape, CARDS, HOSTS, every_card=True)
        assert mesh.training_world(mesh_shape, CARDS) == 4  # one host: cards 0-3 of 4
        return
    world = mesh.training_world(mesh_shape, CARDS, HOSTS, every_card=True)
    assert world == ref.devices.size == CARDS * HOSTS
    for rank in range(world):
        coords = mesh.mesh_layout(mesh_shape, rank, world).coords
        assert ref.devices[coords].id == rank  # device r, host r // 4's card r % 4


@pytest.mark.parametrize("case", ["a host of two", "a named mesh of every card", "a rank",
                                  "a mesh that leaves cards out", "(f) an eval command",
                                  "(f) the dump", "one card a host"])
def test_host_commands_start_a_rank_a_card(case, monkeypatch):
    """A training command on a host of a run (CPCSV_COORDINATOR,
    CPCSV_NUM_PROCESSES = 2, CPCSV_PROCESS_ID) starts one rank a card of
    its host; a launcher's rank (LOCAL_RANK), (f) an eval walk and the dump
    start none; a named mesh must take every card of both hosts; a host of
    one card runs its rank in its own process. An eval command is one
    process a host, its walk on process 0 alone over the whole test set
    while the others wait, as the JAX package's `_centralized`
    (`cpcsv_tpu/evaluation/drivers.py:61-97`):
    `tests/test_torch_parallel.py::test_centralized_walk_runs_on_rank_0`."""
    flags, env, mesh_shape, cards, want = {
        "a host of two": ([], {}, "", 4, 4),
        "a named mesh of every card": ([], {}, "data:4,model:2", 4, 4),
        "a rank": ([], {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, "", 4, 1),
        "a mesh that leaves cards out": ([], {}, "data:4", 4, "takes 4 devices"),
        "(f) an eval command": (["--eval_fid", "1"], {}, "", 4, 1),
        "(f) the dump": (["--load_ckpt", "1"], {}, "", 4, 1),
        "one card a host": ([], {}, "", 1, 1),
    }[case]
    _clear_group_env(monkeypatch)
    for key, value in {"CPCSV_COORDINATOR": "localhost:1", "CPCSV_NUM_PROCESSES": "2",
                       "CPCSV_PROCESS_ID": "1", **env}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    args = main_pororo.parse_args(["--synthetic", "2", *flags])
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            launch.local_world(mesh_shape, args.device, dispatch.trains(args))
        return
    assert launch.local_world(mesh_shape, args.device, dispatch.trains(args)) == want
    if want == 1:  # (f): the CLI starts no ranks, and trains or walks in this process
        started = []
        monkeypatch.setattr(launch, "run_ranks", lambda *a: started.append(a))
        cfg = config_from_file("final.yml").with_updates(MESH_SHAPE=mesh_shape)
        assert dispatch.start_ranks(main_pororo.main, [], args, cfg) is False
        assert started == []


def _meet_all(counts, timeout=30.0):
    """Each host's launcher meets the others in one in-process store, each
    on a thread; what each raised (None where it did not)."""
    store = dist.HashStore()
    raised = [None] * len(counts)

    def host(h):
        try:
            launch.meet(dist.PrefixStore("launch", store), h, len(counts), counts[h], timeout)
        except Exception as e:
            raised[h] = e

    threads = [threading.Thread(target=host, args=(h,)) for h in range(len(counts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return raised


def test_the_launchers_rendezvous_checks_the_hosts():
    """Hosts of equal cards meet; hosts of 4 and 2 cards both raise, naming
    each host's count; a host that never comes fails the rendezvous at its
    timeout, naming it. Nothing trains on fewer hosts or cards."""
    assert _meet_all([4, 4]) == [None, None]
    raised = _meet_all([4, 2])
    for e in raised:
        assert isinstance(e, ValueError) and "host 0 starts 4 rank(s), host 1 starts 2" in str(e)
    store = dist.HashStore()
    with pytest.raises(RuntimeError, match=r"host\(s\) \[1\] of 2 did not join within 0.2 s"):
        launch.meet(store, 0, 2, 4, 0.2)


def test_global_rank_and_world_of_a_hosts_rank(tmp_path, monkeypatch):
    """A rank of a host (LOCAL_RANK, LOCAL_WORLD_SIZE) joins as host × L +
    LOCAL_RANK of hosts × L: here rank 1 × 1 + 0 of 2 × 1 can only be
    checked alone, so one host of one rank by hand (LOCAL_RANK 0 of 1,
    host 0 of 1) joins and says so; LOCAL_RANK without LOCAL_WORLD_SIZE
    raises, as a half-set environment does."""
    _clear_group_env(monkeypatch)
    for key, value in {"CPCSV_COORDINATOR": f"file://{tmp_path / 'rv'}",
                       "CPCSV_NUM_PROCESSES": "1", "CPCSV_PROCESS_ID": "0",
                       "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE is missing"):
        distributed.maybe_initialize_from_env(device="cpu")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    try:
        assert distributed.maybe_initialize_from_env(device="cpu")
        assert distributed.process_info() == (0, 1)
        assert distributed.host_info() == (0, 1, 0, 1)
    finally:
        distributed.destroy_distributed()
    assert distributed.host_info() == (0, 1, 0, 1)


# ---------------------------------------------------------------- (b), (c)
def _cfg(seq: bool, scan: int, per_rank: int = 2):
    cfg = config_from_file("final.yml")
    return cfg.with_updates(GAN=GanConfig(**TINY), USE_SEQ_CONSISTENCY=seq, SCAN_STEPS=scan,
                            MESH_SHAPE="", TRAIN=dataclasses.replace(
                                cfg.TRAIN, ST_BATCH_SIZE=per_rank, IM_BATCH_SIZE=per_rank))


def _datasets(cfg, stories: int):
    story = SyntheticStoryDataset(stories, cfg.VIDEO_LEN, cfg.IMSIZE, cfg.TEXT.DIMENSION,
                                  cfg.LABEL_NUM)
    image = SyntheticImageDataset(stories, cfg.VIDEO_LEN, cfg.IMSIZE, cfg.SESIZE,
                                  cfg.TEXT.DIMENSION, cfg.LABEL_NUM)
    return image, story


def _jax_host_batches(dataset, global_batch: int, seed: int, epoch: int, host: int, hosts: int):
    from cpcsv_tpu.data.loader import DataLoader as JaxDataLoader

    ref = JaxDataLoader(dataset, global_batch, shuffle=True, drop_last=True, seed=seed,
                        process_index=host, process_count=hosts)
    ref.set_epoch(epoch)
    return list(ref)


@pytest.mark.parametrize("hosts,per_host", [(1, 4), (2, 2)])
def test_a_ranks_rows_are_its_share_of_the_jax_host_slice(hosts, per_host, monkeypatch):
    """The training loaders of rank h × L + l (`training_loaders`): the
    image and story loaders read block l of L of the JAX
    `DataLoader(process_index=h, process_count=H)` host slice, index for
    index; with USE_SEQ_CONSISTENCY the story loader reads the host slice
    whole."""
    seed, epoch = 3, 1
    for seq in (False, True):
        cfg = _cfg(seq, 1)
        image, story = _datasets(cfg, 4 * hosts * per_host)
        for rank in range(hosts * per_host):
            _as_rank(monkeypatch, rank, hosts, per_host)
            host, local = divmod(rank, per_host)
            ims, sts, _ = loader_module.training_loaders(cfg, image, story, story, seed)
            for ours, data, off in ((ims, image, 0), (sts, story, 1)):
                ours.set_epoch(epoch)
                ref = _jax_host_batches(data, ours.batch_size, seed + off, epoch, host, hosts)
                got = list(ours)
                assert len(got) == len(ref) == 2
                for g, r in zip(got, ref):
                    n = len(r["images"]) // per_host
                    rows = (slice(None) if ours is sts and seq
                            else slice(local * n, (local + 1) * n))
                    np.testing.assert_array_equal(g["images"], r["images"][rows])


def _spy_steps(trainer, seen: list) -> None:
    """The trainer's steps replaced by spies that keep the story batch of
    each pair (the D step's) or chunk, its rows in order."""
    def record(st):
        seen.append({"images": st["images"].numpy().reshape(-1, *st["images"].shape[-4:]),
                     "shuffled": st["shuffled"].numpy().reshape(-1, *st["shuffled"].shape[-4:]),
                     "order_labels": st["order_labels"].numpy().reshape(-1)})

    def d_step(state, rng, st, im, lr):
        record(st)
        return state, {"x": torch.zeros(())}

    def g_step(state, rng, st, im, lr):
        return state, {"y": torch.zeros(())}

    def scan(state, rng, st, im, lr_d, lr_g):
        record(st)
        return state, {"x": torch.zeros(st["images"].shape[0])}

    trainer.d_step, trainer.g_step = d_step, g_step
    if trainer.scan_steps is not None:
        trainer.scan_steps = scan


@pytest.mark.parametrize("scan", [1, 2], ids=["pairs", "a chunk of 2"])
@pytest.mark.parametrize("hosts,per_host", [(1, 4), (2, 2)])
def test_the_seq_shuffle_is_the_hosts(hosts, per_host, scan, monkeypatch, tmp_path):
    """USE_SEQ_CONSISTENCY, one epoch of 2 story steps, the trainer's pair
    loop (SCAN_STEPS 1) and its chunk path (a chunk of 2): the ranks of a
    host, in rank order, hold exactly `cpcsv_tpu.losses.shuffle.
    create_random_shuffle` over the host's story batches (the JAX loader's
    host slice) with `default_rng([seed, epoch])`, batch after batch, as
    the JAX process of that host shuffles them (`cpcsv_tpu/train/
    trainer.py:127-134`); each rank still steps on its own rows. 1 host × 4
    ranks is the one-command run, whose shuffle is the JAX one process's
    over the global story batch."""
    from cpcsv_tpu.losses.shuffle import create_random_shuffle as jax_shuffle

    seed, epoch = 5, 2
    cfg = _cfg(True, scan)
    image, story = _datasets(cfg, 4 * hosts * per_host)
    got = {}
    for rank in range(hosts * per_host):
        _as_rank(monkeypatch, rank, hosts, per_host)
        ims, sts, _ = loader_module.training_loaders(cfg, image, story, story, seed)
        trainer = trainer_module.GANTrainer(cfg, str(tmp_path / f"rank{rank}"), seed=seed,
                                            device="cpu")
        seen = []
        _spy_steps(trainer, seen)
        trainer._story_rows = trainer._host_story_rows(sts) if hasattr(
            trainer, "_host_story_rows") else (0, 1)
        trainer._np_rng = np.random.default_rng([seed, epoch])
        for ld in (sts, ims):
            ld.set_epoch(epoch)
        images = iter(ims)
        batches = ((st, next(images)) for st in sts)
        run = trainer._pairs if scan == 1 else trainer._chunks
        run(None, None, batches, BatchCopier(torch.device("cpu")), 0.0, 0.0,
            lambda row, i: None, None)
        got[rank] = {key: np.concatenate([s[key] for s in seen]) for key in seen[0]}
    for host in range(hosts):
        refs = _jax_host_batches(story, cfg.TRAIN.ST_BATCH_SIZE * hosts * per_host, seed + 1,
                                 epoch, host, hosts)
        rng = np.random.default_rng([seed, epoch])
        shuffled, labels = zip(*(jax_shuffle(r["images"], rng=rng) for r in refs))
        ranks = range(host * per_host, (host + 1) * per_host)
        for i, ref_images in enumerate(r["images"] for r in refs):
            n = len(ref_images) // per_host
            for local, rank in enumerate(ranks):
                rows = slice(i * n, (i + 1) * n)
                np.testing.assert_array_equal(got[rank]["images"][rows],
                                              ref_images[local * n:(local + 1) * n])
            np.testing.assert_array_equal(
                np.concatenate([got[r]["shuffled"][i * n:(i + 1) * n] for r in ranks]),
                shuffled[i], err_msg=f"host {host}, batch {i}: shuffled")
            np.testing.assert_array_equal(
                np.concatenate([got[r]["order_labels"][i * n:(i + 1) * n] for r in ranks]),
                labels[i], err_msg=f"host {host}, batch {i}: order_labels")


def test_a_loader_of_the_ranks_own_rows_is_refused(monkeypatch, tmp_path):
    """With USE_SEQ_CONSISTENCY in a group of several ranks, a story loader
    that reads this rank's shard alone (not its host's) raises: its shuffle
    would not be the host's."""
    cfg = _cfg(True, 1)
    image, story = _datasets(cfg, 16)
    _as_rank(monkeypatch, 1, 1, 4)
    trainer = trainer_module.GANTrainer(cfg, str(tmp_path), seed=0, device="cpu")
    own = loader_module.DataLoader(story, 8, process_index=1, process_count=4)
    with pytest.raises(ValueError, match=r"reads data shards \(1,\), not this rank's host's"):
        trainer._host_story_rows(own)
    host = loader_module.DataLoader(story, 8, process_index=1, process_count=4,
                                    shards=(0, 1, 2, 3))
    assert trainer._host_story_rows(host) == (1, 4)


# ---------------------------------------------------------------- (e)
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_dead_rank_on_one_host_ends_every_hosts_command(tmp_path):
    """Two host commands of two ranks each meet at a TCP coordinator
    (127.0.0.1, a free port; host 0's launcher serves the store). Rank 3,
    host 1's second, exits 3 while the others wait (as on a collective
    their peer never joins): host 1's command exits 3 naming it, host 0's
    exits 3 within seconds naming host 1's failure, and no rank is left."""
    port = _free_port()
    code = ("import sys; import _torch_launched_rank as rank; "
            "from cpcsv_tpu_torch.parallel import launch; "
            "launch.run_ranks(rank.main, sys.argv[1:], 2)")
    base = {k: v for k, v in os.environ.items() if k not in GROUP_VARIABLES}
    base["PYTHONPATH"] = os.pathsep.join([str(TESTS), str(REPO)])
    t = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path), "3"],
        env={**base, "CPCSV_COORDINATOR": f"127.0.0.1:{port}", "CPCSV_NUM_PROCESSES": "2",
             "CPCSV_PROCESS_ID": str(h)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for h in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    seconds = time.monotonic() - t
    assert procs[1].returncode == 3, outs[1]
    assert "rank 3 of 4 exited 3" in outs[1][1] and "rank 3 of 4 on card 1" in outs[1][1]
    assert procs[0].returncode == 3, outs[0]
    assert "host 0 of 2: rank 3 of 4 exited 3 on host 1" in outs[0][1]
    assert "rank 0 of 4 on card 0" in outs[0][0] and "rank 2 of 4 on card 0" in outs[1][0]
    assert seconds < 30, f"the commands took {seconds:.1f} s (the ranks sleep 60)"
    for rank in range(4):
        assert not chip_smoke.alive(int((tmp_path / f"pid{rank}").read_text())), rank
