"""One command trains over every card of the host (`parallel/launch.py`,
`mesh.training_world`), as one JAX process trains over its local devices.

  * the training world of a MESH_SHAPE over 4 cards against the JAX
    package's `make_mesh` over 4 of its CPU devices, the error of a mesh
    larger than the host among them;
  * when the CLIs start ranks: every condition (a training run, --device
    cuda, no process group in the environment, a world above 1), and the
    CLIs handing their own argv to the launcher;
  * a rank that dies ends the command with its code at once, its output
    printed, no rank left;
  * on two cards (`cuda`-marked): the command's NCCL ranks write the
    snapshot of the same two ranks started by hand, bit for bit.
The launcher's gloo ranks on the CPU against two ranks started by hand are
held in `tests/test_torch_parallel.py` (`test_one_command_writes_the_ranks_snapshot`).
No JAX at the top: the `cuda` test runs where JAX is absent.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import yaml

import chip_smoke
from cpcsv_tpu_torch.cli import dispatch, main_clevr, main_pororo
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.parallel import launch, mesh
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
GROUP_VARIABLES = chip_smoke.GROUP_VARIABLES  # what names a process group to the CLI


@pytest.mark.parametrize("mesh_shape", ["", "data:2", "data:2,model:2", "data:8"])
def test_training_world_is_jax_make_mesh_over_the_cards(mesh_shape):
    """`make_mesh(MESH_SHAPE, devices[:4])`: "" is all 4, a named mesh the
    product of its sizes, on devices 0 .. W − 1 in order (rank r on card r);
    a mesh of more devices than the host's raises in both, naming both
    counts."""
    import jax

    from cpcsv_tpu.parallel import mesh as jax_mesh

    devices = jax.devices()[:4]
    if mesh_shape == "data:8":
        with pytest.raises(AssertionError, match="mesh needs 8 devices, have 4"):
            jax_mesh.make_mesh(mesh_shape, devices)
        with pytest.raises(ValueError, match="needs 8 devices, have 4"):
            mesh.training_world(mesh_shape, 4)
        return
    ref = jax_mesh.make_mesh(mesh_shape, devices)
    world = mesh.training_world(mesh_shape, 4)
    assert world == ref.devices.size
    assert [d.id for d in ref.devices.flat] == [d.id for d in devices[:world]]


# name -> (the CLI's flags besides --cfg, the environment, MESH_SHAPE, visible
# cards, the processes the run takes)
CONDITIONS = {
    "every card": ([], {}, "", 4, 4),
    "a named mesh": ([], {}, "data:2", 4, 2),
    "data and model axes": ([], {}, "data:2,model:2", 4, 4),
    "data:1 keeps one card": ([], {}, "data:1", 4, 1),
    "a host of one card": ([], {}, "", 1, 1),
    "a walk": (["--eval_fid", "1"], {}, "", 4, 1),
    "the dump": (["--load_ckpt", "1"], {}, "", 4, 1),
    "the CPU": (["--device", "cpu"], {}, "", 4, 1),
    "a named card": (["--device", "cuda:1"], {}, "", 4, 1),
    "a rank of a group": ([], {"CPCSV_COORDINATOR": "localhost:1", "CPCSV_NUM_PROCESSES": "2",
                               "CPCSV_PROCESS_ID": "0", "LOCAL_RANK": "0",
                               "LOCAL_WORLD_SIZE": "2"}, "", 4, 1),
    "under torchrun": ([], {"CPCSV_DISTRIBUTED": "1"}, "", 4, 1),
}


@pytest.mark.parametrize("case", list(CONDITIONS))
def test_when_the_cli_starts_ranks(case, monkeypatch):
    """One rank a card of the training world for a training run with
    --device cuda and no process group named in the environment; one
    process (this one) otherwise."""
    flags, env, mesh_shape, cards, world = CONDITIONS[case]
    for key in GROUP_VARIABLES:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    args = main_pororo.parse_args(["--synthetic", "2", *flags])
    assert launch.local_world(mesh_shape, args.device, dispatch.trains(args)) == world
    if world == 4:  # the same run on a mesh larger than the host
        with pytest.raises(ValueError, match="needs 8 devices, have 4"):
            launch.local_world("data:8", args.device, dispatch.trains(args))


@pytest.mark.parametrize("cli", [main_pororo, main_clevr], ids=["pororo", "clevr"])
def test_the_cli_hands_its_arguments_to_the_ranks(cli, monkeypatch, tmp_path):
    """On two cards a training command starts two ranks of itself with the
    same arguments (--backend among them) and trains nothing in its own
    process."""
    for key in GROUP_VARIABLES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    started = []
    monkeypatch.setattr(launch, "run_ranks", lambda *a: started.append(a))
    monkeypatch.setattr(dispatch, "dispatch", lambda *a: pytest.fail("trained in the parent"))
    monkeypatch.chdir(tmp_path)
    argv = ["--synthetic", "2", "--max_epoch", "1", "--backend", "gloo"]
    assert cli.main(argv) is None
    assert started == [(cli.main, argv, 2)]


def test_a_dead_rank_ends_the_command(tmp_path):
    """Rank 1 exits 3 while rank 0 waits (as on a collective its peer never
    joins): the command exits 3 within seconds, with rank 1's output on its
    stderr and rank 0's echoed on its stdout, and no rank alive after."""
    code = ("import sys; import _torch_launched_rank as rank; "
            "from cpcsv_tpu_torch.parallel import launch; "
            "launch.run_ranks(rank.main, sys.argv[1:], 2)")
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARIABLES}
    env["PYTHONPATH"] = os.pathsep.join([str(TESTS), str(REPO)])
    t = time.monotonic()
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=120)
    seconds = time.monotonic() - t
    assert done.returncode == 3, done.stderr
    assert "rank 1 of 2 exited 3" in done.stderr and "rank 1 of 2 on card 1" in done.stderr
    assert "rank 0 of 2 on card 0" in done.stdout
    assert seconds < 30, f"the command took {seconds:.1f} s (rank 0 sleeps 60)"
    for rank in range(2):
        assert not chip_smoke.alive(int((tmp_path / f"pid{rank}").read_text())), rank


def _tiny_yaml(path: Path) -> str:
    """final.yml at narrow widths, MESH_SHAPE data:2, 2 stories and 4 images
    a rank: `--synthetic 8` is 2 steps an epoch."""
    cfg = config_from_file("final.yml")
    cfg = cfg.with_updates(
        MESH_SHAPE="data:2",
        GAN=GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16),
        TRAIN=dataclasses.replace(cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2,
                                  SNAPSHOT_INTERVAL=1))
    path.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    return str(path)


@pytest.mark.cuda
def test_cuda_one_command_trains_as_two_ranks_started_by_hand(tmp_path):
    """`python -m cpcsv_tpu_torch.cli.main_pororo` with no process group in
    its environment on a host of two or more cards, MESH_SHAPE data:2: two
    NCCL ranks on cards 0 and 1, whose checkpoint equals the one of the same
    command started by hand as two ranks of one host (CPCSV_*, LOCAL_RANK,
    LOCAL_WORLD_SIZE, as torchrun starts them), bit for bit
    (cuDNN deterministic in both, through a sitecustomize of chip_smoke.py)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cfg = _tiny_yaml(tmp_path / "tiny.yml")
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARIABLES}
    env["PYTHONPATH"] = os.pathsep.join([chip_smoke.deterministic_site(tmp_path / "site"),
                                         str(REPO)])
    argv = [sys.executable, "-m", "cpcsv_tpu_torch.cli.main_pororo", "--cfg", cfg,
            "--synthetic", "8", "--max_epoch", "2"]
    runs = {}
    for name in ("command", "by_hand"):
        (tmp_path / name).mkdir()
    logs = {}
    for rank in (None, 0, 1):  # the command, then the two ranks by hand
        name = "command" if rank is None else "by_hand"
        extra = {} if rank is None else {
            "CPCSV_COORDINATOR": f"file://{tmp_path / 'rendezvous'}",
            "CPCSV_NUM_PROCESSES": "1", "CPCSV_PROCESS_ID": "0", "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": "2"}
        logs[name, rank] = open(tmp_path / f"{name}{rank}.log", "w")
        runs[name, rank] = subprocess.Popen(argv, cwd=tmp_path / name, env={**env, **extra},
                                            stdout=logs[name, rank], stderr=subprocess.STDOUT)
    try:
        for key, p in runs.items():
            p.wait(timeout=600)
    finally:
        for key, p in runs.items():
            if p.poll() is None:
                p.kill()
            logs[key].close()
    for key, p in runs.items():
        assert p.returncode == 0, (key, (tmp_path / f"{key[0]}{key[1]}.log").read_text()[-3000:])
    model = Path("output", "torch", config_from_file(cfg).CONFIG_NAME, "Model")
    for name in ("train_state_last.pth", "netG_epoch_2.pth"):
        assert chip_smoke.same_snapshot(tmp_path / "command" / model / name,
                                        tmp_path / "by_hand" / model / name) == [], name
