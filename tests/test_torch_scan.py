"""SCAN_STEPS: K alternating D+G updates a chunk (`train/steps.py:make_scan_steps`,
`train/graphs.py`, the trainer's chunk loop), on the CPU, against the JAX
package's `make_scan_steps` and against the port's own pairs one at a time;
the Adam that a CUDA graph can capture (`train/state.py:Adam`) against the
arithmetic it replaced; and, on the card, a captured chunk against eager
pairs.

The CPU tests run the chunks eagerly, as every run on the CPU or under gloo
does. JAX is imported inside the tests that compare with it, so that the
`cuda`-marked test runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_scan.py -m cuda
"""

import copy
import dataclasses
import json
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import synthetic_batches
from cpcsv_tpu_torch.ops.cuda import launches
from cpcsv_tpu_torch.train import state as state_module
from cpcsv_tpu_torch.train.state import create_train_state, make_adam, state_checksums
from cpcsv_tpu_torch.train.steps import captures_chunks, make_scan_steps, make_train_steps
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

# the trainer tests' widths: these tests check the chunking, not the maths
TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)
K = 2  # pairs of the chunk compared with the JAX package's
DRAW = "noise_draw/"  # the JAX scan's metric keys that carry a raw step's noise draws
LR_D, LR_G = 4e-4, 1e-4


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@pytest.fixture(scope="module")
def jax_scan():
    """The JAX package's make_scan_steps, K = 2 pairs of final.yml at
    test_torch_train_step's widths from its initial state, Adam replaced by
    the identity (an SGD step, as that file recovers gradients), and the
    noise each pair drew: JAX's own draws, tapped while the scan runs its
    raw D and G steps at its keys (`split(rng, K)`, then `split(key)` into
    the D's and the G's), each raw step's draws returned among its metrics
    (under DRAW, taken out before the comparison), which the scan stacks
    over the pairs; a pure program, so the compilation cache holds it (a
    host callback would compile it anew every run): (state before, state
    after, stacked metrics, draws, batches)."""
    import jax
    import jax.numpy as jnp
    import optax

    import test_torch_train_step as tts
    from cpcsv_tpu.models import build_models as jax_build_models
    from cpcsv_tpu.train import steps as jax_steps

    jcfg, tcfg = tts.configs("final.yml")
    models = jax_build_models(jcfg)
    state0 = tts.jax_state_from_port(tts.port_init("final.yml"), optax.identity())
    real_steps, real = jax_steps.make_train_steps, jax.random.normal

    def drawing(step, first):
        def run(*args):
            draws = []

            def tap(key, shape=(), dtype=jnp.float32):
                x = real(key, shape, dtype)
                if sys._getframe(1).f_code.co_filename.endswith("models/generator.py"):
                    draws.append(x)
                return x

            with mock.patch.object(jax.random, "normal", tap):
                state, metrics = step(*args)
            return state, {**metrics, **{f"{DRAW}{first + i}": d for i, d in enumerate(draws)}}
        return run

    def raw_steps(*args, **kwargs):
        d_step, g_step = real_steps(*args, **kwargs)
        return drawing(d_step, 0), drawing(g_step, 6)

    with mock.patch.object(jax_steps, "make_adam", lambda cfg=None: optax.identity()), \
            mock.patch.object(jax_steps, "make_train_steps", raw_steps):
        scan = jax_steps.make_scan_steps(jcfg, models, donate=False)
    pairs = [synthetic_batches(tcfg, tts.B_ST, tts.B_IM, seed=10 + k) for k in range(K)]
    st, im = _stack([p[0] for p in pairs]), _stack([p[1] for p in pairs])
    with jax.default_matmul_precision("highest"):
        after, metrics = scan(state0, jax.random.PRNGKey(3), st, im, LR_D, LR_G)
    to_np = lambda s: jax.tree.map(np.array, s)  # noqa: E731
    metrics = to_np(metrics)
    # 6 draws a step (story, then image: CA eps, motion-GRU h0, per-step
    # noise), a D and a G step a pair: the D's under DRAW0-5, the G's 6-11
    stacked = {k: metrics.pop(k) for k in [k for k in metrics if k.startswith(DRAW)]}
    assert set(stacked) == {f"{DRAW}{i}" for i in range(12)}
    draws = [[[stacked[f"{DRAW}{6 * j + i}"][k] for i in range(6)] for j in range(2)]
             for k in range(K)]
    return to_np(state0), to_np(after), metrics, draws, (st, im)


def _sgd_step(self, closure=None):
    """Adam's step replaced by p −= lr·g: the JAX side's identity transform."""
    with torch.no_grad():
        for group in self.param_groups:
            for p in group["params"]:
                p.add_(p.grad * -self.lr.float())


def _port_scan(jax_scan, dtype=torch.float32):
    """The port's make_scan_steps on the JAX scan's state, batches and
    noise, in `dtype` (float64: its plain kernels take any dtype, the float32
    guard of train-mode BN lifted, as test_torch_train_step's float64
    check): (state before as state_dicts, state after, metrics)."""
    import test_torch_train_step as tts
    from cpcsv_tpu_torch.ops import batchnorm, blocks
    from cpcsv_tpu_torch.train import steps as steps_module
    from cpcsv_tpu_torch.utils.weights import load_jax_train_state

    state0, _, _, draws, (st, im) = jax_scan
    _, tcfg = tts.configs("final.yml")
    state = copy.deepcopy(tts.port_init("final.yml"))
    load_jax_train_state(state, state0)
    for net in state.nets().values():
        net.to(dtype)
    before = {n: {k: v.clone() for k, v in net.state_dict().items()}
              for n, net in state.nets().items()}
    noise = [tuple(tuple(tuple(torch.from_numpy(np.array(d)).to(dtype) for d in ds[i:i + 3])
                         for i in (0, 3)) for ds in pair) for pair in draws]
    cast = lambda batch, device: {k: torch.as_tensor(v).to(dtype)  # noqa: E731
                                  for k, v in batch.items()}
    with mock.patch.object(state_module.Adam, "step", _sgd_step), \
            mock.patch.object(steps_module, "batch_to_device", cast), \
            mock.patch.object(blocks, "batch_norm_train", batchnorm._BatchNormTrain.apply):
        state, metrics = make_scan_steps(tcfg)(state, noise, st, im, LR_D, LR_G)
    return before, state, metrics


def test_scan_matches_the_jax_scan(jax_scan):
    """The port's make_scan_steps, K = 2, on the JAX scan's state, stacked
    batches and noise (K explicit (d_noise, g_noise) draws), against the JAX
    scan at test_torch_train_step's tolerances: every stacked metric, and
    after the chunk every BN running statistic and SN u, at its TOL (rtol
    1e-3, atol 1e-4 of the tensor's largest value). The step count advances
    by K. Each net's parameters moved over the chunk by −lr times its two
    pairs' gradients; that change is held as test_torch_train_step holds
    gradients it can hold only against float64, in relative L2 over the
    net's parameters against the port's float64 chunk: the port's float32
    within GRAD_RTOL (1e-2), the JAX package's float32 within
    GRAD_RTOL_CASCADE_G (1e-1). Two pairs at batches of 4 chain the
    cancelling BN sums that ground that bound: the generator's change lies
    6.6e-3 from float64 in the port and 2.5e-2 in the JAX package (per
    tensor up to 3.2e-2 and 9.5e-2, at upsample4_seg's 2-channel BN)."""
    import test_torch_train_step as tts

    state0, after, jax_metrics, _, _ = jax_scan
    before, state, metrics = _port_scan(jax_scan)
    exact_before, exact, _ = _port_scan(jax_scan, torch.float64)
    assert state.step == K
    assert set(metrics) == set(jax_metrics)
    for tag, ref in jax_metrics.items():
        assert metrics[tag].shape == (K,), tag
        tts.close(metrics[tag], ref, tag)
    ref = tts.jax_state_dicts(after)
    theirs = tts.jax_state_dicts(after, grads_of=state0)  # before − after, parameters

    def flat(params):
        return np.concatenate([np.asarray(p, np.float64).ravel() for p in params])

    for name, net in state.nets().items():
        for key, buf in net.named_buffers():
            if key.endswith(("running_mean", "running_var", "weight_u")):
                tts.close(buf, ref[name][key], f"{name}.{key}")
        keys = [key for key, _ in net.named_parameters()]
        after64 = dict(getattr(exact, name).named_parameters())
        exact_change = flat((exact_before[name][k] - after64[k].detach()).numpy() for k in keys)
        ours = flat((before[name][k] - p.detach()).numpy() for k, p in net.named_parameters())
        jax_change = flat(theirs[name][k] for k in keys)
        norm = np.linalg.norm(exact_change)
        assert np.linalg.norm(ours - exact_change) <= tts.GRAD_RTOL * norm, name
        assert np.linalg.norm(jax_change - exact_change) <= tts.GRAD_RTOL_CASCADE_G * norm, name


def _tiny(name="cascade.yml", **keys):
    cfg = config_from_file(name)
    return cfg.with_updates(GAN=TINY, TRAIN=dataclasses.replace(
        cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2, MAX_EPOCH=1, SNAPSHOT_INTERVAL=1), **keys)


def _train(tmp_path, cfg, stories, tag):
    from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
    from cpcsv_tpu_torch.train.trainer import GANTrainer

    run = tmp_path / tag
    state = GANTrainer(cfg, str(run), seed=2, device="cpu").train(
        *synthetic_loaders(cfg, stories, seed=0))
    rows = [json.loads(line) for line in (run / "log" / "metrics.jsonl").read_text().splitlines()]
    return state, [(r["tag"], r["step"], r["value"]) for r in rows if not r["tag"].startswith("perf/")]


@pytest.mark.parametrize("name", ["cascade.yml", "final.yml"])
def test_trainer_chunks_equal_single_pairs(tmp_path, monkeypatch, name, capsys):
    """GANTrainer on the CPU over a 5-step epoch (10 stories at ST_BATCH 2),
    SCAN_STEPS 2 (chunks of 2, 2 and 1, eager on the CPU) against SCAN_STEPS
    1, bit for bit: every metrics.jsonl row and every tensor of the state
    (`state_checksums`: parameters, BN statistics, SN vectors, Adam moments
    and steps). The chunks' host shuffles (USE_SEQ_CONSISTENCY) are held
    against the JAX package's in test_torch_objectives.py."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # metrics.jsonl only
    ref, ref_rows = _train(tmp_path, _tiny(name, SCAN_STEPS=1), 10, "pairs")
    chunks = []
    real = make_scan_steps

    def counting(cfg):
        scan = real(cfg)

        def run(state, rng, st, im, lr_d, lr_g):
            chunks.append(len(st["images"]))
            return scan(state, rng, st, im, lr_d, lr_g)
        return run

    with mock.patch("cpcsv_tpu_torch.train.trainer.make_scan_steps", counting):
        state, rows = _train(tmp_path, _tiny(name, SCAN_STEPS=2), 10, "chunks")
    assert chunks == [2, 2, 1]
    assert "SCAN_STEPS 2: each chunk's pairs run eagerly" in capsys.readouterr().out
    assert rows == ref_rows and any(tag == "st_D/loss" and step == 4 for tag, step, _ in rows)
    assert state.step == ref.step == 5
    assert torch.equal(state_checksums(state), state_checksums(ref))


def test_ragged_batch_flushes_the_chunk():
    """A batch of other shapes ends the chunk before it, and a shorter last
    chunk follows (`cpcsv_tpu/train/trainer.py:300-317`): batches of 2, 2,
    2, 1 at SCAN_STEPS 4 make chunks of 3 and 1."""
    from cpcsv_tpu_torch.data.prefetch import BatchCopier
    from cpcsv_tpu_torch.train.trainer import GANTrainer

    trainer = GANTrainer.__new__(GANTrainer)
    trainer.cfg = _tiny(SCAN_STEPS=4)
    sizes = []

    def scan(state, rng, st, im, lr_d, lr_g):
        sizes.append([len(s) for s in st["images"]])
        return state, {"st_D/loss": torch.zeros(len(st["images"]))}

    trainer.scan_steps, trainer._np_rng = scan, None
    batches = [({"images": np.zeros((b, 5, 2, 2, 3), np.float32)},
                {"images": np.zeros((4, 2, 2, 3), np.float32)}) for b in (2, 2, 2, 1)]
    rows = []
    last, _ = trainer._chunks(None, None, iter(batches), BatchCopier(torch.device("cpu")), LR_D, LR_G,
                              lambda row, i: rows.append(i), None)
    assert sizes == [[2, 2, 2], [1]] and rows == [0, 1, 2, 3]
    assert last is batches[-1][0]


def _pre_pr_adam_step(opt):
    """The arithmetic Adam.step had before its step count and learning rate
    moved to the device: a CPU step, Python-float bias corrections (its
    `.item()`) and one addcdiv."""
    with torch.no_grad():
        for group in opt.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            for p in params:
                if not opt.state[p]:
                    opt.state[p].update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(
                        p, dtype=opt.mu_dtype or p.dtype), exp_avg_sq=torch.zeros_like(p))
            states = [opt.state[p] for p in params]
            grads = [p.grad for p in params]
            stored = [s["exp_avg"] for s in states]
            mu = [m if m.dtype == p.dtype else m.to(p.dtype) for m, p in zip(stored, params)]
            nu = [s["exp_avg_sq"] for s in states]
            steps = [s["step"] for s in states]
            (b1, b2), lr, eps = group["betas"], group["lr"], group["eps"]
            torch._foreach_add_(steps, 1)
            torch._foreach_lerp_(mu, grads, 1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, 1 - b2)
            step_size = [(lr / (1 - b1 ** s.item())) * -1 for s in steps]
            denom = torch._foreach_sqrt(nu)
            torch._foreach_div_(denom, [(1 - b2 ** s.item()) ** 0.5 for s in steps])
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(params, mu, denom, step_size)
            if any(a is not b for a, b in zip(mu, stored)):
                torch._foreach_copy_(stored, mu)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adam_gives_the_bits_of_its_host_arithmetic(mu_dtype):
    """Adam's device step count, device learning rate and float64 device
    bias corrections against the Python-float arithmetic it replaced, bit for
    bit on the CPU: eight steps at a learning rate changed every other step
    (through `set_lr` and through a group's "lr"), then a state_dict in the
    old format (a CPU `step`, torch.optim.Adam's layout) loaded into a fresh
    Adam that resumes for two more steps."""
    rng = np.random.default_rng(7)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 7), (3,), (2, 4, 3))]
    ours = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    ref = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, old = make_adam(ours, mu_dtype), make_adam(ref, mu_dtype)
    lrs = [4e-4, 4e-4, 2e-4, 2e-4, 1e-4, 1e-4, 3e-4, 3e-4, 5e-5, 5e-5]
    for i, lr in enumerate(lrs[:8]):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in p0]
        for p, q, g in zip(ours, ref, grads):
            p.grad, q.grad = g.clone(), g.clone()
        if i % 4 == 0:
            opt.set_lr(lr)
        else:
            opt.param_groups[0]["lr"] = lr
        old.param_groups[0]["lr"] = lr
        opt.step()
        _pre_pr_adam_step(old)
        for p, q in zip(ours, ref):
            assert torch.equal(p, q), i
    saved = copy.deepcopy(old.state_dict())
    assert all(s["step"].device.type == "cpu" and s["step"].dim() == 0
               for s in saved["state"].values())
    resumed = [torch.nn.Parameter(p.detach().clone()) for p in ours]
    opt = make_adam(resumed, mu_dtype)
    opt.load_state_dict(saved)
    for lr in lrs[8:]:
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in p0]
        for p, q, g in zip(resumed, ref, grads):
            p.grad, q.grad = g.clone(), g.clone()
        opt.set_lr(lr)
        old.param_groups[0]["lr"] = lr
        opt.step()
        _pre_pr_adam_step(old)
    for p, q in zip(resumed, ref):
        assert torch.equal(p, q)
    for p, q in zip(resumed, ref):
        a, b = opt.state[p], old.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        assert a["step"] == b["step"] == 10 and a["step"].dtype == torch.float32
    assert opt.lr.dtype == torch.float64 and float(opt.lr) == lrs[-1]


def test_profile_dir_traces_the_second_chunk(tmp_path, monkeypatch, capsys):
    """CPCSV_PROFILE_DIR with SCAN_STEPS > 1: the trace covers the second
    chunk of the first epoch that has one, its first warm chunk, as the JAX
    trainer's (`cpcsv_tpu/train/trainer.py:341-350`); a run of one chunk an
    epoch traces nothing and says so. Stand-in chunks mark themselves with a
    range (a real chunk's trace on the CPU costs seconds)."""
    from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
    from cpcsv_tpu_torch.train import trainer as trainer_module

    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("CPCSV_PROFILE_DIR", str(trace_dir))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    chunks = []

    def stand_in(cfg):
        def scan(state, rng, st, im, lr_d, lr_g):
            chunks.append(len(chunks))
            with torch.profiler.record_function(f"test.chunk_{len(chunks) - 1}"):
                return state, {"st_D/loss": torch.ones(len(st["images"]))}
        return scan

    monkeypatch.setattr(trainer_module, "make_scan_steps", stand_in)
    cfg = _tiny(SCAN_STEPS=3)
    trainer_module.GANTrainer(cfg, str(tmp_path / "short"), device="cpu").train(
        *synthetic_loaders(cfg, 6, seed=0))  # 3 steps: one chunk
    assert not trace_dir.exists()
    assert "no epoch had a chunk 2 of 3 steps to trace" in capsys.readouterr().out
    chunks.clear()
    trainer_module.GANTrainer(cfg, str(tmp_path / "run"), device="cpu").train(
        *synthetic_loaders(cfg, 14, seed=0))  # 7 steps: chunks 0, 1, 2
    assert chunks == [0, 1, 2]
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = [e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]]
    assert {n for n in names if n and n.startswith("test.chunk_")} == {"test.chunk_1"}


def test_launch_records_count_once_a_replay():
    """A capture's launches are recorded, not counted (its kernels do not
    run), and each replay adds the record once; one record at a time."""
    counts = {"a": 0, "b": 0}
    launches.count(counts, "a")
    with launches.recording() as record:
        launches.count(counts, "a")
        launches.count(counts, "b")
        launches.count(counts, "b")
        with pytest.raises(RuntimeError, match="one CUDA graph captures at a time"):
            with launches.recording():
                pass
    assert counts == {"a": 1, "b": 0}
    for _ in range(3):
        launches.add(record)
    assert counts == {"a": 4, "b": 6}
    launches.count(counts, "a")
    assert counts["a"] == 5


def test_chunks_run_eagerly_on_the_cpu():
    """Which way a chunk runs follows from the device (and the process
    group's backend), never from a failed capture: eagerly on the CPU."""
    assert not captures_chunks(torch.device("cpu"))


def _tiny_state(device):
    cfg = _tiny("final.yml", SCAN_STEPS=3)
    return cfg, create_train_state(cfg, seed=0, device=device)


@pytest.mark.cuda
def test_cuda_captured_chunk_equals_eager_pairs():
    """On the card: a chunk of 3 pairs (the first eager, then captured, then
    two replays) and a second chunk that replays all 3, against 6 pairs of
    `make_train_steps` from the same state and generator state, bit for bit:
    every metric and every tensor of the state. Each replay counts its
    kernels' launches. Adam's device arithmetic gives the bits of the host
    arithmetic it replaced on the card too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    assert captures_chunks(dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # eager pairs alike only so
    try:
        _captured_chunk_equals_eager_pairs(dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _captured_chunk_equals_eager_pairs(dev):
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    cfg, eager = _tiny_state(dev)
    scanned = copy.deepcopy(eager)
    chunks = [[synthetic_batches(cfg, 2, 4, seed=20 + 3 * c + k) for k in range(3)]
              for c in range(2)]
    d_step, g_step = make_train_steps(cfg)
    rng = torch.Generator(device=dev).manual_seed(9)
    ref = []
    for chunk in chunks:
        for st, im in chunk:
            _, dm = d_step(eager, rng, st, im, LR_D)
            _, gm = g_step(eager, rng, st, im, LR_G)
            ref.append({k: float(v) for k, v in {**dm, **gm}.items()})
    scan = make_scan_steps(cfg)
    rng.manual_seed(9)
    rows, counts = [], []
    for chunk in chunks:
        before = {**bn_cuda.launches, **dfn_cuda.launches}
        _, metrics = scan(scanned, rng, _stack([p[0] for p in chunk]),
                          _stack([p[1] for p in chunk]), LR_D, LR_G)
        rows += [dict(zip(metrics, r)) for r in torch.stack(list(metrics.values()), 1).tolist()]
        counts.append({k: v - before[k] for k, v in {**bn_cuda.launches,
                                                      **dfn_cuda.launches}.items()})
    assert rows == ref
    assert scanned.step == eager.step == 6
    assert torch.equal(state_checksums(scanned), state_checksums(eager))
    assert len(scan.graphs.graphs) == 1
    assert counts[0] == counts[1] and all(n > 0 for n in counts[0].values())
    for mu_dtype in ("float32", "bfloat16"):  # Adam: the host arithmetic's bits there too
        p0 = torch.randn(64, 33, device=dev)
        params = [torch.nn.Parameter(p0.clone()) for _ in range(2)]
        ours, old = make_adam(params[:1], mu_dtype), make_adam(params[1:], mu_dtype)
        for i, lr in enumerate((4e-4, 4e-4, 2e-4, 1e-4, 3e-4)):
            g = torch.randn(64, 33, device=dev)
            params[0].grad, params[1].grad = g.clone(), g.clone()
            ours.set_lr(lr)
            old.param_groups[0]["lr"] = lr
            ours.step()
            _pre_pr_adam_step(old)
            assert torch.equal(params[0], params[1]), (mu_dtype, i)


@pytest.mark.cuda
def test_cuda_a_failed_capture_raises():
    """No fallback: a pair that reads a loss on the host cannot be captured,
    and the chunk raises instead of running its pairs eagerly; no graph is
    kept. (Last in the file: a failed capture may leave the card's stream
    state to the process that made it.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cpcsv_tpu_torch.train import steps as steps_module

    dev = torch.device("cuda")
    cfg, state = _tiny_state(dev)
    batches = [synthetic_batches(cfg, 2, 4, seed=40 + k) for k in range(3)]
    scan = make_scan_steps(cfg)
    real = steps_module._step

    def reading(net, opt, loss):
        loss.item()  # a host sync: refused while a CUDA graph captures
        real(net, opt, loss)

    with mock.patch.object(steps_module, "_step", reading), pytest.raises(RuntimeError):
        scan(state, torch.Generator(device=dev).manual_seed(1), _stack([b[0] for b in batches]),
             _stack([b[1] for b in batches]), LR_D, LR_G)
    assert scan.graphs.graphs == {}
