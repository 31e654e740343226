"""The port's data parallelism (`cpcsv_tpu_torch/parallel/`) on the CPU: two
gloo ranks against one process and against the JAX package.

The contract is the JAX package's (`cpcsv_tpu/parallel/mesh.py`,
`tests/test_multiprocess.py`): a run on W ranks equals a one-process run on
the same global batches up to the order of its reductions. A mesh with
other axes than `data` (the JAX package's `make_mesh` layout) shards the
batches over `data` and replicates over the rest. Two launches of two ranks
and one of four (`tests/_torch_parallel_worker.py`, a `file://` rendezvous
in the test's directory, so that parallel test workers never race for a
port):

  * `steps`: for final.yml (v1), cascade.yml and the variants
    USE_SEQ_CONSISTENCY (shuffled stories fed as input), USE_INFONCE and
    SEGMENT_LEARNING false, at test_torch_train_step.py's tiny widths and 2
    rows a rank (4 global), one D and one G step from one state with the
    same global noise: the wrong pair of a rank's last row takes the next
    rank's first condition, and the last rank's wrong-pair head sees one
    row; and final.yml under MESH_SHAPE data:1,model:2, each rank the 4
    rows, bit for bit one process. Then a D+G step, a save, a restore on
    both ranks and one more step; a train-mode BN whose rows all lie on
    rank 0; a --load_ckpt dump through the centralized walk;
  * `cli`: `cli.main_pororo` with MESH_SHAPE data:2 for one epoch, then an
    auto-resumed one, against a straight two-epoch run; its --load_ckpt dump;
    `cli.main_clevr` for one epoch; both CLIs for one epoch under
    data:1,model:2 against one process at the doubled batches, bit for bit;
  * `mesh`: four ranks under data:2,model:2, one D+G step of final.yml, bit
    for bit the `steps` launch's two ranks on the same global batch;
  * one command of two ranks through the CLIs' launcher
    (`parallel/launch.py`), --device cpu and gloo: the `cli` launch's
    straight run, bit for bit; and two host commands of `cli.main_clevr`,
    two ranks each under data:2,model:2 (the data groups across the hosts):
    the `cli` launch's clevr run, bit for bit.

Tolerances: the metrics at rtol 1e-3 / atol 1e-4, as
`tests/test_multiprocess.py` holds the JAX package; the two ranks bit for
bit equal; against the JAX package's step, test_torch_train_step.py's. Each
net's gradient (all its parameters as one vector) within relative L2 1e-5
of one process, on the same steps run in float64 (the CPU's plain kernels
take any dtype): there the two agree to ~3e-14, so the arithmetic of the
split is the one-process arithmetic. In float32 the BN, loss and gradient
sums run in other orders, and a train-mode BN over 2-4 rows carries those
last bits far: the float32 gradients lie up to 4.2e-3 apart (the seq G
step; 1e-6 to 3e-4 elsewhere), as test_torch_train_step.py's float32 JAX
and port gradients lie up to 2.5e-3 apart at the same batches, so float32
is held to that file's 1e-2.
"""

import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import test_torch_train_step as tts
from cpcsv_tpu.data.loader import DataLoader as JaxDataLoader
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.loader import DataLoader
from cpcsv_tpu_torch.data.synthetic import synthetic_batches
from cpcsv_tpu_torch.losses.shuffle import create_random_shuffle
from cpcsv_tpu_torch.parallel import distributed, mesh
from cpcsv_tpu_torch.train.state import create_train_state
from cpcsv_tpu_torch.utils.weights import load_jax_train_state
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

import _torch_parallel_worker as worker

WORLD, LOCAL = 2, 2  # ranks, rows a rank of both batches
B = WORLD * LOCAL  # test_torch_train_step's B_ST, B_IM
SCENARIOS = {
    "final": ("final.yml", {}),
    "cascade": ("cascade.yml", {}),
    "seq": ("final.yml", {"USE_SEQ_CONSISTENCY": True}),
    "infonce": ("final.yml", {"USE_INFONCE": True}),
    "noseg": ("final.yml", {"SEGMENT_LEARNING": False}),
    "model": ("final.yml", {}),
}
# the scenarios the ranks run on a mesh other than "" (one process runs
# their global batch alone): a model axis, each rank the whole batch
MESHES = {"model": "data:1,model:2"}
FOUR = "data:2,model:2"  # the four-rank launch's mesh, against "" on two ranks
GRAD_REL_L2 = 1e-5  # float64
GRAD_REL_L2_F32 = tts.GRAD_RTOL  # float32, 1e-2 (see the docstring)
TOL = dict(rtol=1e-3, atol=1e-4)
# seconds a launch may take: about 15-25 on one idle core, 8-40 beside the
# other test processes; the ranks are waited on together and a rank that
# fails ends the launch at once (`worker.wait_ranks`)
TIMEOUT = 120
# the widths of the scenarios and CLI runs that are not compared with the
# JAX package (the sampler and scan tests' widths); final.yml's scenario
# takes test_torch_train_step.py's, the JAX run's
NARROW = dict(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)


def _cfg(name, keys, widths=None):
    return config_from_file(name).with_updates(GAN=GanConfig(**(widths or NARROW)), **keys)


def _scenario(sid, jax_run):
    """The job of one scenario: the config, the initial state dicts, the
    global batches and the global noise of the D and the G step."""
    name, keys = SCENARIOS[sid]
    widths = tts.TINY if sid == "final" else NARROW  # final: the JAX run's
    cfg = _cfg(name, keys, widths)
    if sid == "final":  # the JAX package's state, batches and noise draws
        state0, outs, (st, im) = jax_run
        state = copy.deepcopy(tts.port_init("final.yml"))
        load_jax_train_state(state, state0)
        noise = [tuple(tuple(torch.from_numpy(np.array(d)) for d in outs[w][2][i:i + 3])
                       for i in (0, 3)) for w in ("d", "g")]
    else:
        state = create_train_state(cfg, seed=1, device="cpu")
        st, im = synthetic_batches(cfg, B, B, seed=4)
        if cfg.USE_SEQ_CONSISTENCY:
            shuffled, labels = create_random_shuffle(st["images"], rng=np.random.default_rng(7))
            st = {**st, "shuffled": shuffled, "order_labels": labels}
        gen = torch.Generator().manual_seed(11)
        noise = [(state.gen.draw_noise(B, cfg.VIDEO_LEN, gen), state.gen.draw_noise(B, 1, gen))
                 for _ in range(2)]
    return {"id": sid, "cfg": (name, widths, keys), "mesh": MESHES.get(sid),
            "state": {n: {k: v.clone() for k, v in net.state_dict().items()}
                      for n, net in state.nets().items()},
            "st": {k: np.asarray(v) for k, v in st.items()},
            "im": {k: np.asarray(v) for k, v in im.items()},
            "noise_d": noise[0], "noise_g": noise[1]}


def _launch(mode, job, root: Path, env=None, world: int = WORLD):
    """Start `world` ranks of the worker; returns a function that waits for
    them and loads each rank's result."""
    job_path = root / f"{mode}_job.pt"
    torch.save(job, job_path)
    init = f"file://{root / f'{mode}_rendezvous'}"
    outs = [root / f"{mode}_rank{rank}.pt" for rank in range(world)]
    logs = [root / f"{mode}_rank{rank}.log" for rank in range(world)]
    procs = worker.start_ranks(
        [[sys.executable, worker.__file__, mode, str(rank), str(world), init, str(job_path),
          str(out)] for rank, out in enumerate(outs)], logs,
        [{**os.environ, "OMP_NUM_THREADS": "1", **(env(rank) if env else {})}
         for rank in range(world)])

    def wait():
        worker.wait_ranks(procs, logs, TIMEOUT, f"the {mode} launch")
        results = [torch.load(o, weights_only=False) for o in outs]
        for path in (job_path, *outs):  # hundreds of MB: rank 0's gradients in float64
            path.unlink()
        return results

    return wait


def _tiny_yaml(path: Path, name: str, mesh: str = f"data:{WORLD}", **train) -> str:
    """`name`'s keys at the tiny widths, MESH_SHAPE `mesh`, `train` in TRAIN."""
    cfg = _cfg(name, {})
    d = dataclasses.asdict(cfg.with_updates(MESH_SHAPE=mesh, TRAIN=dataclasses.replace(
        cfg.TRAIN, **train)))
    path.write_text(yaml.safe_dump(d))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three launches and the one-process references computed
    meanwhile: the steps ranks start on the scenarios of the port's own
    states while this process runs the JAX package's step, then read its
    scenario; the four ranks start with it. {"steps": [rank0, rank1],
    "one": one process, "cli": [rank0, rank1], "cli_one": the CLIs in one
    process, "four": [rank0, ..., rank3] on FOUR, "jax":
    test_torch_train_step's final.yml run}."""
    root = tmp_path_factory.mktemp("parallel").resolve()
    cli_root = root / "cli"
    cli_root.mkdir()
    # --synthetic 8: 8 stories, 2 story steps an epoch at 4 global; 16 images,
    # 2 image batches at 8 global, so an epoch drains the image loader once
    # and a resumed epoch starts where the straight run's does
    train = dict(IM_BATCH_SIZE=2 * LOCAL, ST_BATCH_SIZE=LOCAL, SNAPSHOT_INTERVAL=1)
    pororo = _tiny_yaml(cli_root / "final_dp.yml", "final.yml", **train)
    clevr = _tiny_yaml(cli_root / "clevr_dp.yml", "clevr.yml", **train)
    # a model axis: the same global batches, each rank the whole of them,
    # against one process at the doubled batches
    model_yamls = {name: (_tiny_yaml(cli_root / f"{name}_model.yml", f"{name}.yml",
                                     mesh=MESHES["model"], **train),
                          _tiny_yaml(cli_root / f"{name}_one.yml", f"{name}.yml", mesh="",
                                     **{**train, "IM_BATCH_SIZE": 2 * B, "ST_BATCH_SIZE": B}))
                   for name in ("final", "clevr")}
    base = ["--synthetic", "8", "--device", "cpu"]
    cli_job = {"root": str(cli_root), "runs": {
        "straight": ("pororo", str(cli_root / "a"), ["--cfg", pororo, *base, "--max_epoch", "2"]),
        "first": ("pororo", str(cli_root / "b"), ["--cfg", pororo, *base, "--max_epoch", "1"]),
        "resumed": ("pororo", str(cli_root / "b"),
                    ["--cfg", pororo, *base, "--max_epoch", "2", "--continue_ckpt", "auto"]),
        "dump": ("pororo", str(cli_root / "b"), ["--cfg", pororo, *base, "--load_ckpt", "2"]),
        "clevr": ("clevr", str(cli_root / "c"), ["--cfg", clevr, *base, "--max_epoch", "1"]),
        **{f"{name}_model": ("clevr" if name == "clevr" else "pororo",
                             str(cli_root / f"{name}_model"),
                             ["--cfg", files[0], *base, "--max_epoch", "1"])
           for name, files in model_yamls.items()},
    }}
    # the straight run again as one command of two ranks, through the CLIs'
    # launcher (`parallel.launch.run_ranks`), beside the launches
    (cli_root / "one_command").mkdir()
    one_command_log = root / "one_command.log"
    with open(one_command_log, "w") as log:
        one_command = subprocess.Popen(
            [sys.executable, "-c", "import sys; from cpcsv_tpu_torch.cli import main_pororo; "
             "from cpcsv_tpu_torch.parallel import launch; "
             "launch.run_ranks(main_pororo.main, sys.argv[1:], 2)",
             "--cfg", pororo, *base, "--max_epoch", "2", "--backend", "gloo"],
            cwd=cli_root / "one_command", stdout=log, stderr=subprocess.STDOUT,
            env={**{k: v for k, v in os.environ.items() if not k.startswith("CPCSV_")},
                 "OMP_NUM_THREADS": "1", "PYTHONPATH": str(worker.REPO)})
    # the clevr run again as two host commands of two ranks each under FOUR,
    # its data groups across the hosts, at the same global batches
    (cli_root / "two_hosts").mkdir()
    four_yaml = _tiny_yaml(cli_root / "clevr_hosts.yml", "clevr.yml", mesh=FOUR,
                           **{**train, "IM_BATCH_SIZE": LOCAL, "ST_BATCH_SIZE": LOCAL // 2})
    host_logs = [root / f"host{h}.log" for h in range(2)]
    hosts = []
    for h, host_log in enumerate(host_logs):
        with open(host_log, "w") as log:
            hosts.append(subprocess.Popen(
                [sys.executable, "-c", "import sys; from cpcsv_tpu_torch.cli import main_clevr; "
                 "from cpcsv_tpu_torch.parallel import launch; "
                 "launch.run_ranks(main_clevr.main, sys.argv[1:], 2)",
                 "--cfg", four_yaml, *base, "--max_epoch", "1", "--backend", "gloo"],
                cwd=cli_root / "two_hosts", stdout=log, stderr=subprocess.STDOUT,
                env={**{k: v for k, v in os.environ.items() if not k.startswith("CPCSV_")},
                     "OMP_NUM_THREADS": "1", "PYTHONPATH": str(worker.REPO),
                     "CPCSV_COORDINATOR": f"file://{root / 'hosts_rendezvous'}",
                     "CPCSV_NUM_PROCESSES": "2", "CPCSV_PROCESS_ID": str(h)}))
    cli = _launch("cli", cli_job, root, env=lambda rank: {
        "CPCSV_COORDINATOR": f"file://{root / 'cli_rendezvous'}",
        "CPCSV_NUM_PROCESSES": str(WORLD), "CPCSV_PROCESS_ID": str(rank)})

    bn_rng = np.random.default_rng(5)
    first = root / "final_scenario.pt"  # the JAX run's, read by the ranks when written
    job = {"root": str(root / "steps"), "run_dir": str(root / "steps" / "run"),
           "scenarios": [_scenario(sid, None) for sid in SCENARIOS if sid != "final"],
           "first": str(first), "test_stories": 6, "test_batch": WORLD,
           "bn": {"x": bn_rng.standard_normal((3, 5, 2, 2)).astype(np.float32) * 2 + 0.5,
                  "w": bn_rng.standard_normal((3, 5, 2, 2)).astype(np.float32),
                  "split": [3, 0]}}
    steps = _launch("steps", job, root)

    jax_run = tts._run("final.yml")
    final = _scenario("final", jax_run)
    torch.save(final, root / "final_scenario.tmp")
    os.replace(root / "final_scenario.tmp", first)
    four = _launch("mesh", {"root": str(root / "four"), "scenarios": [final], "mesh": FOUR},
                   root, world=2 * WORLD)
    one_job = {**job, "root": str(root / "one"), "run_dir": str(root / "one" / "run"),
               "scenarios": [final, *job["scenarios"]], "first": None}
    one = worker.run_steps(one_job, 0, 1, None)
    cli_one = worker.run_cli({"root": str(cli_root), "runs": {
        f"{name}_model": ("clevr" if name == "clevr" else "pororo", str(cli_root / f"{name}_one"),
                          ["--cfg", files[1], *base, "--max_epoch", "1"])
        for name, files in model_yamls.items()}}, 0, 1, None)
    out = {"steps": steps(), "one": one, "cli": cli(), "cli_one": cli_one, "four": four(),
           "jax": jax_run, "root": root}
    try:
        one_command.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        one_command.kill()
        one_command.wait()
    out["one_command"] = (one_command.returncode, one_command_log)
    for p in hosts:
        try:
            p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    out["two_hosts"] = [(p.returncode, log) for p, log in zip(hosts, host_logs)]
    first.unlink()
    return out


def _rel_l2(a: dict, ref: dict) -> float:
    a = np.concatenate([a[k].ravel() for k in sorted(ref)]).astype(np.float64)
    r = np.concatenate([ref[k].ravel() for k in sorted(ref)]).astype(np.float64)
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_two_ranks_equal_one_process(runs, sid):
    """Metrics, every stepped net's gradient, and the BN running statistics
    and SN vectors the step left, two ranks against one process, in float32;
    the gradients also in float64."""
    two, one = runs["steps"][0][sid], runs["one"][sid]
    for which in ("d", "g"):
        assert set(two[which]["metrics"]) == set(one[which]["metrics"])
        for tag, ref in one[which]["metrics"].items():
            np.testing.assert_allclose(two[which]["metrics"][tag], ref, **TOL,
                                       err_msg=f"{sid} {which} {tag}")
        assert set(two[which]["grads"]) == set(one[which]["grads"])
        for precision, tol in (("float32", GRAD_REL_L2_F32), ("float64", GRAD_REL_L2)):
            got = two if precision == "float32" else runs["steps"][0]["float64"][sid]
            ref = one if precision == "float32" else runs["one"]["float64"][sid]
            for net, grads in ref[which]["grads"].items():
                err = _rel_l2(got[which]["grads"][net], grads)
                assert err <= tol, f"{sid} {which} step {precision}, d {net}: relative L2 {err:.3e}"
        for net, tensors in one[which]["tensors"].items():
            for key, ref in tensors.items():
                scale = float(np.abs(ref).max()) or 1.0
                np.testing.assert_allclose(two[which]["tensors"][net][key], ref,
                                           rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                                           err_msg=f"{sid} {which} {net}.{key}")


@pytest.mark.parametrize("sid", list(SCENARIOS))
def test_ranks_stay_equal_bit_for_bit(runs, sid):
    """Parameters after Adam, BN running statistics, SN vectors, Adam
    moments (the state's checksums), gradients and metrics: the same bits on
    both ranks."""
    r0, r1 = runs["steps"][0][sid], runs["steps"][1][sid]  # rank 1's gradients as bit sums
    for which in ("d", "g"):
        assert r0[which]["metrics"] == r1[which]["metrics"]
        np.testing.assert_array_equal(r0[which]["checksums"], r1[which]["checksums"])
        assert worker.grad_bits(r0)[which]["grads"] == r1[which]["grads"]
        for net, tensors in r0[which]["tensors"].items():
            for key, value in tensors.items():
                np.testing.assert_array_equal(r1[which]["tensors"][net][key], value,
                                              err_msg=f"{sid} {which} {net}.{key}")


@pytest.mark.parametrize("which", ["d", "g"])
def test_two_rank_step_matches_jax(runs, which):
    """final.yml: the two ranks' step on the JAX package's state, global batch
    and noise against `cpcsv_tpu.train.steps.make_train_steps` on one device,
    at test_torch_train_step.py's tolerances."""
    state0, outs, _ = runs["jax"]
    jax_after, jax_metrics, _ = outs[which]
    two = runs["steps"][0]["final"][which]
    assert set(two["metrics"]) == set(jax_metrics)
    for tag, value in jax_metrics.items():
        np.testing.assert_allclose(two["metrics"][tag], float(value), **tts.TOL, err_msg=tag)
    after = tts.jax_state_dicts(jax_after)
    grads = tts.jax_state_dicts(jax_after, grads_of=state0)
    for net, tensors in two["tensors"].items():
        for key, value in tensors.items():
            tts.close(torch.from_numpy(value), after[net][key], f"{which} {net}.{key}")
    for net, got in two["grads"].items():
        ref = {k: np.asarray(grads[net][k]) for k in got}
        floor = tts.GRAD_FLOOR * max(np.linalg.norm(g) for g in ref.values())
        for key, g in got.items():
            err = np.linalg.norm(g - ref[key])
            assert err <= tts.GRAD_RTOL * max(np.linalg.norm(ref[key]), floor), (
                f"{which} step, d {net}.{key}: error {err:.3e}")


def test_save_restore_and_continue_on_both_ranks(runs):
    """Rank 0 saves, both ranks restore the state bit for bit, and the next
    D+G step agrees across ranks and with one process."""
    r0, r1 = (r["resume"] for r in runs["steps"])
    assert r0["differ"] == r1["differ"] == [], "restored state tensors differ from the saved"
    np.testing.assert_array_equal(r0["checksums"], r1["checksums"])
    assert r0["metrics"] == r1["metrics"]
    for tag, ref in runs["one"]["resume"]["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][tag], ref, **TOL, err_msg=tag)
    assert runs["steps"][1]["written"] == [], "rank 1 wrote files"


def test_empty_local_map_joins_the_collectives(runs):
    """A train-mode BN whose 3 rows all lie on rank 0: rank 1's empty map
    launches nothing and still joins the forward's and the backward's
    all-reduce; rank 0 computes what one process does on the 3 rows, the
    ranks' dscale and dbias add up to one process's, the running
    statistics are the global ones on both ranks."""
    r0, r1 = (r["bn"] for r in runs["steps"])
    one = runs["one"]["bn"]
    assert r1["y"].shape == (0, 5, 2, 2) and r1["dx"].shape == (0, 5, 2, 2)
    for key in ("y", "dx"):
        np.testing.assert_allclose(r0[key], one[key], rtol=1e-5, atol=1e-6, err_msg=key)
    for key in ("dscale", "dbias"):
        np.testing.assert_array_equal(r1[key], np.zeros_like(r1[key]))
        np.testing.assert_allclose(r0[key] + r1[key], one[key], rtol=1e-5, atol=1e-6)
    for key in ("running_mean", "running_var"):
        np.testing.assert_array_equal(r0[key], r1[key])
        np.testing.assert_allclose(r0[key], one[key], rtol=1e-6, atol=1e-7)


def test_centralized_walk_runs_on_rank_0(runs):
    """The --load_ckpt dump through `_centralized`: rank 0 walks the whole
    test set and writes the one-process dump's PNGs, rank 1 waits and
    returns None, writing nothing."""
    r0, r1 = (r["walk"] for r in runs["steps"])
    assert r1 is None
    one_dir = Path(runs["one"]["walk"][0])
    ours = sorted(Path(r0[0]).glob("*.png"))
    assert [p.name for p in ours] == [p.name for p in sorted(one_dir.glob("*.png"))]
    assert len(ours) == 6 * 5  # every test story's frames, not rank 0's slice
    for p in ours:
        assert p.read_bytes() == (one_dir / p.name).read_bytes(), p.name


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_model_axis_equals_one_process_bit_for_bit(runs, precision):
    """MESH_SHAPE data:1,model:2: each rank reads the whole global batch and
    its data group is itself, so one D and one G step from one state give
    one process's bits on both ranks: metrics, gradients, the state's
    checksums, the BN statistics and SN vectors."""
    ranks = [r if precision == "float32" else r["float64"] for r in runs["steps"]]
    one = (runs["one"] if precision == "float32" else runs["one"]["float64"])["model"]
    one_bits = worker.grad_bits(one)
    for rank, got in enumerate(r["model"] for r in ranks):
        for which in ("d", "g"):
            assert got[which]["metrics"] == one[which]["metrics"], (rank, which)
            np.testing.assert_array_equal(got[which]["checksums"], one[which]["checksums"])
            if rank == 0:
                for net, grads in one[which]["grads"].items():
                    for key, g in grads.items():
                        np.testing.assert_array_equal(got[which]["grads"][net][key], g,
                                                      err_msg=f"{which} {net}.{key}")
            else:  # rank 1's gradients come as bit sums
                assert got[which]["grads"] == one_bits[which]["grads"], which
            for net, tensors in one[which]["tensors"].items():
                for key, value in tensors.items():
                    np.testing.assert_array_equal(got[which]["tensors"][net][key], value,
                                                  err_msg=f"{which} {net}.{key}")


def test_four_ranks_on_data_and_model_axes_equal_two_on_data(runs):
    """MESH_SHAPE data:2,model:2 on four ranks against "" (data:2) on two, the
    same global batch, state and noise, one D+G step: rank r reads data
    shard r // 2, sums over its data group {r % 2, r % 2 + 2}, and ends with
    the metrics, state and gradients of the two-rank run's rank r // 2, bit
    for bit (a sum of two operands does not depend on their order). The
    two ranks' one data group is the default group; the four form two."""
    two = [r["dg"] for r in runs["steps"]]
    assert two[0]["metrics"] == two[1]["metrics"]
    assert all(r["default_group"] for r in two)
    assert not any(r["dg"]["default_group"] for r in runs["four"])
    for rank, r in enumerate(runs["four"]):
        ref = two[rank // 2]
        assert r["dg"]["metrics"] == ref["metrics"], rank
        np.testing.assert_array_equal(r["dg"]["checksums"], ref["checksums"], err_msg=str(rank))
        assert r["dg"]["grad_bits"] == ref["grad_bits"], rank
        assert rank == 0 or r["written"] == []


def test_cli_trains_on_a_model_axis(runs):
    """MESH_SHAPE data:1,model:2 through `cli.main_pororo` and `cli.main_clevr`
    on two ranks, one epoch: every step's metrics and the final state equal
    one process's at the doubled batches (the same global batches) bit for
    bit, on both ranks; rank 1 writes no file."""
    r0, r1 = runs["cli"]
    for name in ("final_model", "clevr_model"):
        one = runs["cli_one"][name]
        assert len(one["history"]) == 2 * 2, name
        for r in (r0, r1):
            assert r[name]["history"] == one["history"], name
            np.testing.assert_array_equal(r[name]["checksums"], one["checksums"], err_msg=name)
    assert r1["written"] == []


def test_cli_trains_with_two_ranks(runs):
    """MESH_SHAPE data:2 through `cli.main_pororo` and `cli.main_clevr` with two
    ranks: the ranks' metrics equal every step; one epoch plus an
    auto-resumed one ends in the straight two-epoch run's state and metrics,
    bit for bit; the dump runs on rank 0; rank 1 writes no file."""
    r0, r1 = runs["cli"]
    for name in ("straight", "first", "resumed", "clevr"):
        assert r0[name]["history"] == r1[name]["history"], name
        assert len(r0[name]["history"]) == 2 * 2 * (2 if name == "straight" else 1)
        np.testing.assert_array_equal(r0[name]["checksums"], r1[name]["checksums"])
    np.testing.assert_array_equal(r0["resumed"]["checksums"], r0["straight"]["checksums"])
    assert r0["first"]["history"] + r0["resumed"]["history"] == r0["straight"]["history"]
    assert r1["dump"]["returned"] is None and r0["dump"]["returned"] is not None
    samples = runs["root"] / "cli" / "b" / r0["dump"]["returned"][0]
    assert len(list(samples.glob("*.png"))) == 4 * 5  # the 4 test stories (one batch of 4)
    assert r1["written"] == []
    log = runs["root"] / "cli" / "a" / "output" / "torch" / "final_model" / "log" / "metrics.jsonl"
    tags = [line for line in log.read_text().splitlines() if '"st_D/loss"' in line]
    assert len(tags) == 2 * 2, "one metrics.jsonl row a step: rank 0 alone logs"


def test_one_command_writes_the_ranks_snapshot(runs):
    """The CLIs' launcher (`parallel.launch.run_ranks`) given --device cpu,
    gloo and 2 ranks, MESH_SHAPE data:2, 2 epochs: its run directory holds
    the checkpoint of the same 2 ranks started by hand with CPCSV_* (the
    `cli` launch's straight run), bit for bit."""
    code, log = runs["one_command"]
    assert code == 0, log.read_text()[-3000:]
    model = Path("output", "torch", "final_model", "Model")
    for name in ("train_state_last.pth", "netG_epoch_2.pth"):
        assert chip_smoke.same_snapshot(runs["root"] / "cli" / "one_command" / model / name,
                                        runs["root"] / "cli" / "a" / model / name) == [], name


def test_two_host_commands_write_the_ranks_snapshot(runs):
    """Two host commands of `cli.main_clevr` (CPCSV_COORDINATOR a `file://`
    store, CPCSV_NUM_PROCESSES 2, CPCSV_PROCESS_ID 0 and 1), each starting
    two gloo ranks through `parallel.launch.run_ranks` with --device cpu,
    MESH_SHAPE data:2,model:2 at half the batches a rank: ranks 0-1 on host
    0, 2-3 on host 1, data groups {0, 2} and {1, 3} across the hosts, the
    same global batches as the two ranks of data:2. After one epoch the run
    directory holds the checkpoint of the `cli` launch's clevr run, bit for
    bit; rank 0 says 4 ranks on 2 hosts of 2."""
    for code, log in runs["two_hosts"]:
        assert code == 0, log.read_text()[-3000:]
    said = runs["two_hosts"][0][1].read_text()
    assert (f"DATA PARALLEL: 4 ranks on 2 host(s) of 2, MESH_SHAPE {FOUR}, global batches IM "
            f"{2 * B} / ST {B}") in said, said[-3000:]
    model = Path("output", "torch", "clevr_model", "Model")
    for name in ("train_state_last.pth", "netG_epoch_0.pth", "netG_epoch_1.pth"):
        assert chip_smoke.same_snapshot(runs["root"] / "cli" / "two_hosts" / model / name,
                                        runs["root"] / "cli" / "c" / model / name) == [], name


@pytest.mark.parametrize("shuffle,n,batch", [(True, 23, 4), (False, 10, 4), (True, 8, 2)],
                         ids=str)
def test_loader_slices_match_jax(shuffle, n, batch):
    """Each process's slice of every global batch, the dropped partial batch,
    and `unsliced()`, index for index against the JAX package's loader."""
    class Items:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"i": np.asarray([i])}

    for epoch in (0, 3):
        for pi in range(WORLD):
            ours = DataLoader(Items(), batch, shuffle=shuffle, seed=5, process_index=pi,
                              process_count=WORLD)
            ref = JaxDataLoader(Items(), batch, shuffle=shuffle, seed=5, process_index=pi,
                                process_count=WORLD)
            for loader in (ours, ref):
                loader.set_epoch(epoch)
            assert len(ours) == len(ref) == n // batch
            got = [b["i"].ravel().tolist() for b in ours]
            assert got == [b["i"].ravel().tolist() for b in ref]
            assert all(len(b) == batch // WORLD for b in got)
            full = [b["i"].ravel().tolist() for b in ours.unsliced()]
            assert full == [b["i"].ravel().tolist() for b in ref.unsliced()]
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(Items(), 3, process_index=0, process_count=WORLD)


def test_group_of_one_rank_gives_one_process_bits(tmp_path):
    """A gloo group of one rank runs every collective, each exact: final.yml's
    D and G step give the one-process bits (metrics, gradients, state)."""
    sc = _scenario("seq", None)
    alone = worker.run_steps_one(sc)
    distributed.initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cpu")
    try:
        assert distributed.is_distributed() and distributed.process_info() == (0, 1)
        grouped = worker.run_steps_one(sc)
    finally:
        distributed.destroy_distributed()
    assert not distributed.is_distributed()
    for which in ("d", "g"):
        assert grouped[which]["metrics"] == alone[which]["metrics"]
        np.testing.assert_array_equal(grouped[which]["checksums"], alone[which]["checksums"])
        for part in ("grads", "tensors"):
            for net, tensors in alone[which][part].items():
                for key, value in tensors.items():
                    np.testing.assert_array_equal(grouped[which][part][net][key], value,
                                                  err_msg=f"{which} {part} {net}.{key}")


# (MESH_SHAPE, every rank's coordinates, the data groups): the JAX package's
# device layout, `np.asarray(devices).reshape(sizes)`, rank r at
# np.unravel_index(r, sizes)
LAYOUTS = {
    "data:2,model:2": ([(0, 0), (0, 1), (1, 0), (1, 1)], ((0, 2), (1, 3))),
    "model:2,data:2": ([(0, 0), (0, 1), (1, 0), (1, 1)], ((0, 1), (2, 3))),
    "data:2,model:1,replica:2": ([(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)], ((0, 2), (1, 3))),
}


@pytest.mark.parametrize("mesh_shape", list(LAYOUTS))
def test_mesh_layout_and_the_loader_slices(mesh_shape):
    """Each rank's coordinates, data index and data group over four ranks,
    and the rows its loader reads: data shard d of 2 of every global batch,
    the replicas of a shard the same rows, the two shards the whole batch."""
    coords, groups = LAYOUTS[mesh_shape]
    data_axis = [name for name, _ in mesh.parse_mesh_shape(mesh_shape)].index("data")

    class Items:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return {"i": np.asarray([i])}

    rows = {}
    for rank in range(4):
        layout = mesh.mesh_layout(mesh_shape, rank, 4)
        assert layout.coords == coords[rank] and layout.groups == groups
        assert (layout.data_index, layout.data_count) == (coords[rank][data_axis], 2)
        group = next(g for g in groups if rank in g)
        assert group.index(rank) == layout.data_index
        loader = DataLoader(Items(), 4, shuffle=True, seed=3, process_index=layout.data_index,
                            process_count=layout.data_count)
        loader.set_epoch(1)
        rows[rank] = [b["i"].ravel().tolist() for b in loader]
    full = DataLoader(Items(), 4, shuffle=True, seed=3)
    full.set_epoch(1)
    full = [b["i"].ravel().tolist() for b in full]
    for rank in range(4):
        d = coords[rank][data_axis]
        assert rows[rank] == [b[2 * d:2 * d + 2] for b in full]


@pytest.mark.parametrize("mesh_shape,rank,world,shard", [
    ("data:1,model:2", 1, 2, (0, 1)),
    ("", 1, 2, (1, 2)),
    ("data:2,model:2", 1, 4, (0, 2)),
    ("model:2,data:2", 1, 4, (1, 2)),
])
def test_training_loaders_read_the_config_meshs_shard(monkeypatch, mesh_shape, rank, world,
                                                      shard):
    """The loaders a training run builds (`synthetic_loaders`, as
    `build_pororo_loaders` and `clevr_loaders`, through `training_loaders`)
    read the data shard of cfg.MESH_SHAPE's layout over (rank, world),
    with no process group or data group formed; a walk's (rank, world) is taken as given,
    on any well-formed mesh, and a mesh training refuses raises."""
    from cpcsv_tpu_torch.cli import dispatch
    from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
    from cpcsv_tpu_torch.data import loader

    monkeypatch.setattr(loader, "process_info", lambda: (rank, world))
    monkeypatch.setattr(distributed, "process_info", lambda: (rank, world))
    cfg = _cfg("final.yml", {"MESH_SHAPE": mesh_shape})
    cfg = cfg.with_updates(TRAIN=dataclasses.replace(cfg.TRAIN, IM_BATCH_SIZE=2, ST_BATCH_SIZE=2))
    walk = SimpleNamespace(eval_fid=True, eval_fvd=False, eval_is=False, eval_ssim=False,
                           load_ckpt=None)
    train = SimpleNamespace(**{**vars(walk), "eval_fid": False})
    assert dispatch.loader_shard(train) is None
    for loaders, want in ((synthetic_loaders(cfg, 8, 0, dispatch.loader_shard(train)), shard),
                          (synthetic_loaders(cfg, 8, 0, dispatch.loader_shard(walk)),
                           (rank, world))):
        assert [(ld.process_index, ld.process_count) for ld in loaders] == [want] * 3
    refused = cfg.with_updates(MESH_SHAPE="model:" + str(world))
    with pytest.raises(ValueError, match="no 'data' axis"):
        synthetic_loaders(refused, 8, 0)
    test = synthetic_loaders(refused, 8, 0, dispatch.loader_shard(walk))[2]
    assert (test.process_index, test.process_count) == (rank, world)


@pytest.mark.parametrize("mesh_shape,world,match", [
    ("model:2", 2, "no 'data' axis"),
    ("data:2,data:1", 2, "named twice"),
    ("data:2,model:2", 2, "spans 4 ranks but the run has 2 processes"),
    ("data:1,model:2", 1, "spans 2 ranks but the run has 1 process"),
    ("data:2,model", 4, "NAME:SIZE"),
])
def test_a_training_mesh_the_jax_trainer_refuses_raises(mesh_shape, world, match):
    """No `data` axis, a duplicate axis, a size other than the world's, a
    malformed axis: ValueError, before any group forms."""
    with pytest.raises(ValueError, match=match):
        mesh.mesh_layout(mesh_shape, 0, world)


def test_mesh_shape_parsing_and_the_environment(monkeypatch):
    """mesh_size and the layout of a one-process mesh; a half-set environment
    raises, and none leaves the process alone."""
    assert mesh.mesh_size("") == 1 and mesh.mesh_size("data:4") == 4
    assert mesh.parse_mesh_shape("data:4,model:2") == [("data", 4), ("model", 2)]
    with pytest.raises(ValueError, match="NAME:SIZE"):
        mesh.parse_mesh_shape("data")
    one = mesh.check_training_mesh("data:1,model:1")
    assert (one.coords, one.data_index, one.data_count, one.groups) == ((0, 0), 0, 1, ((0,),))
    assert mesh.check_training_mesh("").axes == (("data", 1),)
    with pytest.raises(ValueError, match="spans 2 ranks"):
        mesh.check_training_mesh("data:2")
    mesh.check_training_mesh("data:1")
    for key in ("CPCSV_COORDINATOR", "CPCSV_NUM_PROCESSES", "CPCSV_PROCESS_ID",
                "CPCSV_DISTRIBUTED"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.maybe_initialize_from_env(device="cpu") is False
    monkeypatch.setenv("CPCSV_COORDINATOR", "localhost:1")
    monkeypatch.setenv("CPCSV_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="CPCSV_PROCESS_ID"):
        distributed.maybe_initialize_from_env(device="cpu")
    assert not distributed.is_distributed()
    assert mesh.wrong_pair_rows(mesh.Rows(2, 2, 4)) == mesh.Rows(2, 1, 3)
    assert mesh.wrong_pair_rows(mesh.Rows(1, 1, 2)) == mesh.Rows(1, 0, 1)


def test_a_failed_rank_ends_the_launch_at_once(tmp_path):
    """`worker.wait_ranks`: a rank that exits non-zero fails the launch at
    once, its peer (here one that would sleep for a minute, as a rank waits
    on a rendezvous its failed peer never joins) killed, both outputs in
    the message; ranks that all exit 0 return."""
    import time

    logs = [tmp_path / f"rank{r}.log" for r in range(2)]
    code = ["import sys; print('rank 0 fails'); sys.exit(3)", "import time; time.sleep(60)"]
    procs = worker.start_ranks([[sys.executable, "-c", c] for c in code], logs,
                               [dict(os.environ)] * 2)
    t = time.monotonic()
    with pytest.raises(AssertionError, match="rank 0 exited 3:\nrank 0 fails"):
        worker.wait_ranks(procs, logs, TIMEOUT, "a launch")
    assert time.monotonic() - t < 30 and procs[1].returncode is not None
    procs = worker.start_ranks([[sys.executable, "-c", "pass"]] * 2, logs, [dict(os.environ)] * 2)
    worker.wait_ranks(procs, logs, TIMEOUT, "a launch")
