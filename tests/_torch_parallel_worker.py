"""One rank of the port's data-parallel tests (`tests/test_torch_parallel.py`),
on the CPU in a gloo process group:

    python tests/_torch_parallel_worker.py steps RANK WORLD INIT_URL JOB OUT
    python tests/_torch_parallel_worker.py cli RANK WORLD INIT_URL JOB OUT
    python tests/_torch_parallel_worker.py bn RANK WORLD INIT_URL JOB OUT
    python tests/_torch_parallel_worker.py mesh RANK WORLD INIT_URL JOB OUT

`steps` joins the group through `initialize_distributed` and runs the JOB
file's scenarios (a config, a state, the global batches and noise, and for
some a MESH_SHAPE of the ranks): one D and one G step each from the state,
on this rank's data shard, in float32 and in float64; then D+G, a save, a
restore and one more D+G step of the first; then a --load_ckpt dump
through the centralized walk. Where the JOB names a `first` file, the
first scenario is read from it once the caller has written it (the JAX
package's run, which the caller computes while the ranks step the
others). `mesh` joins the group with the JOB's MESH_SHAPE and runs the
first scenario's D+G step on its data shard. `cli` runs the port's CLIs
in this process, the group formed from CPCSV_COORDINATOR /
CPCSV_NUM_PROCESSES / CPCSV_PROCESS_ID, which the caller sets (the tests
also call it in their own process, with none). `bn` runs train-mode BNs on
this rank's rows on the card, the gloo group's all-reduce summing the
kernels' sums (`tests/test_torch_bn.py`, `cuda`-marked). Each rank writes what it saw to OUT (torch.save); a rank
other than 0 also lists every file it opened for writing, which must be none.
"""

import builtins
import copy
import os
import sys
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def start_ranks(argvs, logs, envs):
    """One process a rank: argv, output file and environment each."""
    import subprocess

    procs = []
    for argv, log, env in zip(argvs, logs, envs):
        with open(log, "w") as out:  # the child keeps its own descriptor
            procs.append(subprocess.Popen(argv, env=env, stdout=out, stderr=subprocess.STDOUT))
    return procs


def wait_ranks(procs, logs, timeout: float, what: str) -> None:
    """Waits for all ranks together. As soon as one exits non-zero, or once
    `timeout` seconds have passed, kills the others (which would otherwise
    wait out a rendezvous or a collective) and fails with every rank's
    output; returns once all have exited 0."""
    import time

    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes) or all(c == 0 for c in codes):
            break
        if time.monotonic() > deadline:
            break
        time.sleep(0.1)
    if all(c == 0 for c in codes):
        return
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    late = " (timed out)" if all(c in (None, 0) for c in codes) else ""
    raise AssertionError(f"{what}{late}:\n" + "\n".join(
        f"rank {rank} exited {p.returncode}:\n{Path(log).read_text()[-3000:]}"
        for rank, (p, log) in enumerate(zip(procs, logs))))


def _writes_recorder(root: Path):
    """Patches builtins.open to list the files opened for writing under `root`."""
    written, real_open = [], builtins.open

    def spying(file, mode="r", *args, **kwargs):
        if (isinstance(file, (str, os.PathLike)) and any(m in mode for m in "wax+")
                and str(Path(file).resolve()).startswith(str(root))):
            written.append(str(file))
        return real_open(file, mode, *args, **kwargs)

    return written, mock.patch.object(builtins, "open", spying)


def _config(job_cfg):
    from cpcsv_tpu_torch.config import GanConfig, config_from_file

    name, gan, keys = job_cfg
    return config_from_file(name).with_updates(GAN=GanConfig(**gan), **keys)


def _mesh_config(sc, world):
    """The scenario's config, with its MESH_SHAPE where it names one and the
    run has several ranks (one process runs the same global batch alone)."""
    cfg = _config(sc["cfg"])
    return cfg.with_updates(MESH_SHAPE=sc["mesh"]) if world > 1 and sc.get("mesh") else cfg


def _local(batch: dict, cfg, rank: int, world: int) -> dict:
    """This rank's data shard of a global batch, as the loader slices it."""
    from cpcsv_tpu_torch.parallel.mesh import mesh_layout

    layout = mesh_layout(cfg.MESH_SHAPE, rank, world)
    n = len(next(iter(batch.values())))
    local = n // layout.data_count
    lo = layout.data_index * local
    return {k: v[lo:lo + local] for k, v in batch.items()}


def _state(cfg, sd):
    from cpcsv_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, seed=0, device="cpu")
    for name, net in state.nets().items():
        net.load_state_dict(sd[name])
    return state


def _reading(state, stepped) -> dict:
    """What a step left: the stepped nets' gradients (float32 numpy), every
    net's BN running statistics and SN vectors, and the checksums of the
    whole state (`train.state.state_checksums`: parameters after the Adam
    step, buffers, Adam moments)."""
    from cpcsv_tpu_torch.train.state import state_checksums

    nets = state.nets()
    return {
        "grads": {n: {k: p.grad.float().numpy().copy() for k, p in nets[n].named_parameters()}
                  for n in stepped},
        "tensors": {n: {k: v.numpy().copy() for k, v in net.state_dict().items()
                        if k.endswith(("running_mean", "running_var", "weight_u"))}
                    for n, net in nets.items()},
        "checksums": state_checksums(state).numpy(),
    }


def _grad_bits(state) -> list:
    """int sums of the bit patterns of every parameter's gradient, nets in
    `state.nets()` order: equal gradients give equal sums."""
    return [int(p.grad.detach().float().numpy().view(np.int32).astype(np.int64).sum())
            for net in state.nets().values() for p in net.parameters()]


def run_dg(sc, rank: int, world: int) -> dict:
    """The scenario's D step then its G step on one state, on this rank's
    data shard: the metrics, the state's checksums, the gradients' bits and
    whether the collectives ran on the default group."""
    from cpcsv_tpu_torch.parallel.distributed import data_group
    from cpcsv_tpu_torch.train.state import state_checksums
    from cpcsv_tpu_torch.train.steps import make_train_steps

    cfg = _mesh_config(sc, world)
    st, im = _local(sc["st"], cfg, rank, world), _local(sc["im"], cfg, rank, world)
    d_step, g_step = make_train_steps(cfg)
    state = _state(cfg, sc["state"])
    _, dm = d_step(state, sc["noise_d"], st, im, 4e-4)
    _, gm = g_step(state, sc["noise_g"], st, im, 1e-4)
    return {"metrics": {k: float(v) for k, v in {**dm, **gm}.items()},
            "checksums": state_checksums(state).numpy(), "grad_bits": _grad_bits(state),
            "default_group": data_group() is None, "state": state}


def grad_bits(res: dict) -> dict:
    """A `run_steps_one` result with each gradient replaced by the int64 sum
    of its bit pattern (a checksum that equal gradients share)."""
    return {which: {**r, "grads": {n: {k: int(g.view(np.int32).astype(np.int64).sum())
                                       for k, g in grads.items()}
                                   for n, grads in r["grads"].items()}}
            for which, r in res.items()}


def run_steps_one(sc, rank: int = 0, world: int = 1, dtype=torch.float32) -> dict:
    """One scenario's D step and G step, each from its state, on this rank's
    rows: {"d" | "g": metrics, gradients, tensors}. dtype float64 runs the
    nets, batches, noise and the plain BN in float64 (the CPU's plain
    versions take any dtype; train-mode BN's float32 guard is lifted)."""
    from cpcsv_tpu_torch.ops import batchnorm, blocks
    from cpcsv_tpu_torch.train import steps as steps_module
    from cpcsv_tpu_torch.train.steps import make_train_steps

    cfg = _mesh_config(sc, world)
    st, im = _local(sc["st"], cfg, rank, world), _local(sc["im"], cfg, rank, world)
    d_step, g_step = make_train_steps(cfg)
    wide = dtype == torch.float64
    cast = (lambda batch, device: {k: torch.as_tensor(v).to(dtype)  # noqa: E731
                                   for k, v in batch.items() if isinstance(v, np.ndarray)})
    res = {}
    for which, step, noise, stepped in (
            ("d", d_step, sc["noise_d"], [n for n in ("d_im", "d_st", "d_se") if n in sc["state"]]),
            ("g", g_step, sc["noise_g"], ["gen"])):
        state = _state(cfg, sc["state"])
        if wide:
            for net in state.nets().values():
                net.to(dtype)
            noise = tuple(tuple(t.to(dtype) for t in draws) for draws in noise)
        with mock.patch.object(steps_module, "batch_to_device", cast) if wide else \
                mock.patch.dict({}), mock.patch.object(
                    blocks, "batch_norm_train", batchnorm._BatchNormTrain.apply) if wide else \
                mock.patch.dict({}):
            _, metrics = step(state, noise, st, im, 4e-4)
        res[which] = {"metrics": {k: float(v) for k, v in metrics.items()},
                      **_reading(state, stepped)}
    return res


def bn_reading(bn_job: dict, rank: int, device: str) -> dict:
    """A train-mode BatchNorm2d forward and backward (loss sum(w · y)) on this
    rank's rows of bn_job's x, split by bn_job["split"]: y, dx, dscale and
    dbias (this rank's), the running statistics, and the BN kernels'
    launches (on a CUDA device)."""
    from cpcsv_tpu_torch.ops.blocks import BatchNorm2d
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    lo = sum(bn_job["split"][:rank])
    rows = slice(lo, lo + bn_job["split"][rank])
    x = torch.from_numpy(bn_job["x"][rows]).to(device).requires_grad_()
    bn = BatchNorm2d(x.shape[1]).to(device).train()
    before = dict(bn_cuda.launches)
    y = bn(x)
    (y * torch.from_numpy(bn_job["w"][rows]).to(device)).sum().backward()
    out = {k: v.detach().cpu().numpy().copy() for k, v in (
        ("y", y), ("dx", x.grad), ("dscale", bn.weight.grad), ("dbias", bn.bias.grad),
        ("running_mean", bn.running_mean), ("running_var", bn.running_var))}
    out["launches"] = {k: bn_cuda.launches[k] - before[k] for k in before}
    return out


def read_when_written(path: str, timeout: float = 120.0):
    """What the caller saves to `path` (written elsewhere, then renamed
    there), once it is there."""
    import time

    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written within {timeout:.0f} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def run_steps(job, rank, world, out_dir):
    from cpcsv_tpu_torch.data.loader import DataLoader
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset
    from cpcsv_tpu_torch.evaluation.drivers import Infer
    from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
    from cpcsv_tpu_torch.train.state import check_replicas, state_checksums
    from cpcsv_tpu_torch.train.steps import make_train_steps

    scenarios = list(job["scenarios"])
    result = {sc["id"]: run_steps_one(sc, rank, world) for sc in scenarios}
    if job.get("first"):
        scenarios.insert(0, read_when_written(job["first"]))
        result[scenarios[0]["id"]] = run_steps_one(scenarios[0], rank, world)
    result["float64"] = {sc["id"]: run_steps_one(sc, rank, world, torch.float64)
                         for sc in scenarios}

    # a D+G step, a save, a restore on every rank, one more D+G step
    sc = scenarios[0]
    dg = run_dg(sc, rank, world)
    state = dg.pop("state")
    result["dg"] = dg
    cfg = _config(sc["cfg"])
    st, im = _local(sc["st"], cfg, rank, world), _local(sc["im"], cfg, rank, world)
    d_step, g_step = make_train_steps(cfg)
    saved = state_checksums(state)
    ckpt = CheckpointManager(job["run_dir"] + "/Model")
    ckpt.save(state, 1, completed=0)
    restored = _state(cfg, sc["state"])
    ckpt.restore(restored)
    check_replicas(restored)
    differ = (saved != state_checksums(restored)).nonzero().ravel().tolist()
    _, dm = d_step(restored, sc["noise_g"], st, im, 4e-4)
    _, gm = g_step(restored, sc["noise_d"], st, im, 1e-4)
    result["resume"] = {"differ": differ,
                        "metrics": {k: float(v) for k, v in {**dm, **gm}.items()},
                        "checksums": state_checksums(restored).numpy()}

    # a train-mode BN whose rows all lie on rank 0: rank 1's map is empty
    result["bn"] = bn_reading(job["bn"], rank, "cpu")

    # the --load_ckpt dump, centralized: rank 0 over the whole test set
    test = SyntheticStoryDataset(job["test_stories"], cfg.VIDEO_LEN, cfg.IMSIZE,
                                 cfg.TEXT.DIMENSION, cfg.LABEL_NUM, seed=99)
    loader = DataLoader(test, job["test_batch"], drop_last=True, process_index=rank,
                        process_count=world)
    infer = Infer(cfg, output_dir=job["run_dir"], device="cpu", load_ckpt=1)
    result["walk"] = infer.inference_samples(loader, job["run_dir"] + "/walk")
    return result


def run_cli(job, rank, world, out_dir):
    from cpcsv_tpu_torch.cli import main_clevr, main_pororo
    from cpcsv_tpu_torch.train import trainer as trainer_module

    history = []

    def spying_steps(cfg):
        d_step, g_step = make_steps(cfg)

        def spy(step):
            def run(*args):
                state, metrics = step(*args)
                history.append({k: float(v) for k, v in metrics.items()})
                return state, metrics
            return run

        return spy(d_step), spy(g_step)

    def spying_scan(cfg):
        """SCAN_STEPS > 1: each pair of a chunk as a D and a G entry, as above."""
        scan = make_scan(cfg)

        def run(*args):
            state, metrics = scan(*args)
            for row in torch.stack(list(metrics.values()), 1).tolist():
                row = dict(zip(metrics, row))
                d = {k: v for k, v in row.items() if "_D/" in k or k.endswith("_D")}
                history.extend([d, {k: v for k, v in row.items() if k not in d}])
            return state, metrics
        return run

    make_steps, make_scan = trainer_module.make_train_steps, trainer_module.make_scan_steps
    result, home = {}, os.getcwd()
    try:
        with mock.patch.object(trainer_module, "make_train_steps", spying_steps), \
                mock.patch.object(trainer_module, "make_scan_steps", spying_scan):
            for name, (cli, cwd, argv) in job["runs"].items():
                os.makedirs(cwd, exist_ok=True)
                os.chdir(cwd)
                history.clear()
                module = main_clevr if cli == "clevr" else main_pororo
                out = module.main(argv)
                result[name] = {"history": copy.deepcopy(history)}
                if hasattr(out, "nets"):
                    from cpcsv_tpu_torch.train.state import state_checksums

                    result[name]["checksums"] = state_checksums(out).numpy()
                else:
                    result[name]["returned"] = out
    finally:
        os.chdir(home)  # the tests also run this in their own process
    return result


def main():
    mode, rank, world, init, job_path, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    written, spy = _writes_recorder(Path(job["root"]).resolve())
    if mode in ("steps", "bn", "mesh"):
        from cpcsv_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(init, world, rank, backend="gloo", device=job.get("device", "cpu"))
    with spy if rank != 0 else mock.patch.dict({}):
        if mode == "bn":  # on the card: each case of job["bn"]
            result = {"cases": [bn_reading(case, rank, job["device"]) for case in job["bn"]]}
        elif mode == "mesh":
            sc = {**job["scenarios"][0], "mesh": job["mesh"]}
            result = {"dg": {k: v for k, v in run_dg(sc, rank, world).items() if k != "state"}}
        else:
            result = (run_steps if mode == "steps" else run_cli)(job, rank, world, out)
    result["written"] = written
    if mode == "steps" and rank != 0:  # the test compares them with rank 0's bit for bit
        for key in [k for k in result if isinstance(result[k], dict) and "d" in result[k]]:
            result[key] = grad_bits(result[key])
        result["float64"] = {sid: grad_bits(r) for sid, r in result["float64"].items()}
    torch.save(result, out)
    from cpcsv_tpu_torch.parallel.distributed import destroy_distributed

    destroy_distributed()


if __name__ == "__main__":
    main()
